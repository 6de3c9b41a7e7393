"""SMILES writer: Molecule -> SMILES string.

The port's copy of polymer_chemprop_tpu chem/write.py. Counterpart of the
parser in :mod:`.smiles`; replaces ``Chem.MolToSmiles``
uses in the reference (subgraph extraction for interpretation,
reference interpret.py:133-200; error messages in featurization). Output is
deterministic (canonical-ish start ordering via Weisfeiler-Lehman ranks)
and round-trips through :func:`parse_smiles`, but does not reproduce
RDKit's canonical form byte-for-byte.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from .mol import AROMATIC, DOUBLE, Molecule, SINGLE, TRIPLE
from .periodic import NUM_TO_SYMBOL, ORGANIC_SUBSET

_BOND_SYM = {SINGLE: "", DOUBLE: "=", TRIPLE: "#", 4: "$"}


def _wl_ranks(mol: Molecule, atoms: Set[int]) -> Dict[int, int]:
    colors = {}
    for a in atoms:
        at = mol.atoms[a]
        colors[a] = hash((at.atomic_num, at.formal_charge, at.num_hs,
                          at.is_aromatic)) & 0xFFFFFFFF
    for _ in range(4):
        new = {}
        for a in atoms:
            nbrs = sorted(colors[b.other(a)] for b in mol.atom_bonds(a)
                          if b.other(a) in atoms)
            new[a] = hash((colors[a], tuple(nbrs))) & 0xFFFFFFFF
        colors = new
    order = sorted(atoms, key=lambda a: (colors[a], a))
    return {a: i for i, a in enumerate(order)}


def _atom_token(mol: Molecule, a: int, subset: Set[int]) -> str:
    atom = mol.atoms[a]
    if atom.is_wildcard():
        m = atom.props.get("atom_map")
        return f"[*:{m}]" if m else "*"
    sym = NUM_TO_SYMBOL.get(atom.atomic_num, "*")
    aromatic = atom.is_aromatic
    token_sym = sym.lower() if aromatic else sym
    # count hydrogens that the parser's implicit model would re-derive:
    # organic-subset atom with default H count, no charge/isotope/chirality
    simple = (sym in ORGANIC_SUBSET and atom.formal_charge == 0
              and atom.isotope == 0 and atom.chiral_tag == 0)
    if simple:
        # check that implicit-H recomputation on the subgraph reproduces
        # num_hs; else emit explicit bracket H count
        from .periodic import default_valence
        bo = 0.0
        for b in mol.atom_bonds(a):
            if b.other(a) not in subset:
                continue
            bo += 1 if b.order == AROMATIC else b.order
        if aromatic:
            bo += 1 if _needs_pi_token(mol, a, subset) else 0
        valences = default_valence(atom.atomic_num, 0)
        target = next((v for v in valences if v >= bo), valences[-1] if valences else 0)
        if int(target - round(bo)) == atom.num_hs and not (aromatic and atom.atomic_num == 7 and atom.num_hs > 0):
            return token_sym
    h = atom.num_hs
    parts = ["["]
    if atom.isotope:
        parts.append(str(atom.isotope))
    parts.append(token_sym)
    if atom.chiral_tag == 2:
        parts.append("@")
    elif atom.chiral_tag == 1:
        parts.append("@@")
    if h == 1:
        parts.append("H")
    elif h > 1:
        parts.append(f"H{h}")
    c = atom.formal_charge
    if c == 1:
        parts.append("+")
    elif c == -1:
        parts.append("-")
    elif c > 1:
        parts.append(f"+{c}")
    elif c < -1:
        parts.append(f"-{-c}")
    m = atom.props.get("atom_map")
    if m:
        parts.append(f":{m}")
    parts.append("]")
    return "".join(parts)


def _needs_pi_token(mol: Molecule, a: int, subset: Set[int]) -> bool:
    for b in mol.atom_bonds(a):
        if b.other(a) in subset and b.order == AROMATIC and b.kekule_order == DOUBLE:
            return True
    return False


def _bond_token(mol: Molecule, b, a_from: int) -> str:
    if b.order == AROMATIC or b.is_aromatic:
        return ""  # aromatic bonds implicit between lowercase atoms
    if b.order == SINGLE and mol.atoms[b.a1].is_aromatic \
            and mol.atoms[b.a2].is_aromatic:
        return "-"  # explicit single between aromatic atoms (biphenyl link)
    return _BOND_SYM.get(b.order, "")


def write_smiles(mol: Molecule, atoms: Optional[Set[int]] = None) -> str:
    """Write SMILES for the whole molecule or an induced atom subset.

    Components (disconnected pieces within the subset) are joined by '.'.
    """
    subset = set(atoms) if atoms is not None else {a.idx for a in mol.atoms}
    if not subset:
        return ""
    ranks = _wl_ranks(mol, subset)
    visited: Set[int] = set()
    ring_bonds: Dict[int, int] = {}  # bond idx -> ring closure digit
    next_digit = [1]
    out_parts: List[str] = []

    # pre-identify back edges via DFS per component
    def component(start: int) -> str:
        tokens: List[str] = []
        back_edges: Set[int] = set()
        seen: Set[int] = set()
        stack = [start]
        parent_edge: Dict[int, int] = {}
        order: List[int] = []
        while stack:
            u = stack.pop()
            if u in seen:
                continue
            seen.add(u)
            order.append(u)
            for b in sorted(mol.atom_bonds(u), key=lambda b: ranks.get(b.other(u), 0)):
                v = b.other(u)
                if v not in subset:
                    continue
                if v in seen:
                    if parent_edge.get(u) != b.idx:
                        back_edges.add(b.idx)
                else:
                    parent_edge[v] = b.idx
                    stack.append(v)

        digit_of: Dict[int, str] = {}

        def digit_str(n: int) -> str:
            return str(n) if n < 10 else f"%{n:02d}"

        def emit(u: int, via_bond) -> None:
            if via_bond is not None:
                tokens.append(_bond_token(mol, via_bond, u))
            tokens.append(_atom_token(mol, u, subset))
            visited.add(u)
            # ring closures opening/closing at this atom
            for b in sorted(mol.atom_bonds(u), key=lambda b: b.idx):
                if b.idx in back_edges and b.other(u) in subset:
                    if b.idx not in digit_of:
                        digit_of[b.idx] = digit_str(next_digit[0])
                        next_digit[0] += 1
                        tokens.append(_bond_token(mol, b, u) + digit_of[b.idx])
                    else:
                        tokens.append(digit_of[b.idx])
            children = [(b, b.other(u)) for b in
                        sorted(mol.atom_bonds(u), key=lambda b: ranks.get(b.other(u), 0))
                        if b.other(u) in subset and b.idx not in back_edges
                        and parent_edge.get(b.other(u)) == b.idx
                        and b.other(u) not in visited]
            for i, (b, v) in enumerate(children):
                if i < len(children) - 1:
                    tokens.append("(")
                    emit(v, b)
                    tokens.append(")")
                else:
                    emit(v, b)

        emit(start, None)
        return "".join(tokens)

    starts = sorted(subset, key=lambda a: (ranks[a], a))
    for s in starts:
        if s not in visited:
            out_parts.append(component(s))
    return ".".join(out_parts)


def extract_subgraph_smiles(mol: Molecule, atoms: Set[int]) -> Optional[str]:
    """SMILES of an induced subgraph, validated by re-parsing (the
    reference's extract_subgraph returns None on unparseable fragments,
    interpret.py:133-200)."""
    from .smiles import parse_smiles
    try:
        smi = write_smiles(mol, atoms)
    except Exception:
        return None
    if not smi:
        return None
    if parse_smiles(smi, strict=False) is None:
        return None
    return smi
