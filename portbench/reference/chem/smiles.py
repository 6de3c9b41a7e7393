# Frozen copy of polymer_chemprop_tpu_torch/chem/smiles.py, the benchmark reference's
# own featurizer: later changes to the port do not reach it.
"""SMILES parser producing :class:`~polymer_chemprop_tpu_torch.chem.mol.Molecule`.

Replaces ``Chem.MolFromSmiles`` used by the reference (chemprop/rdkit.py:3-18).
Supports the OpenSMILES subset needed by the Chemprop data family:

* organic subset atoms (B C N O P S F Cl Br I) and aromatic b c n o s p
* bracket atoms ``[isotope symbol chirality Hcount charge :map]`` including
  wildcards ``[*]`` / ``[*:n]`` (polymer attachment points)
* bonds ``- = # : / \\``, branches, ring-closure digits and ``%nn``
* dot-separated fragments (kept in one Molecule, no bond between them)

After parsing, :meth:`Molecule.perceive` runs ring/aromaticity/kekulization/
implicit-H/hybridization/conjugation perception, so downstream featurization
(features/featurization.py) sees RDKit-equivalent atom/bond attributes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .mol import (
    AROMATIC,
    CHI_TETRAHEDRAL_CCW,
    CHI_TETRAHEDRAL_CW,
    DOUBLE,
    Molecule,
    Atom,
    SINGLE,
    TRIPLE,
)
from .periodic import AROMATIC_ORGANIC, ORGANIC_SUBSET, SYMBOL_TO_NUM

_BOND_ORDERS = {"-": SINGLE, "=": DOUBLE, "#": TRIPLE, ":": AROMATIC,
                "/": SINGLE, "\\": SINGLE, "$": 4}

_TWO_LETTER = {"Cl", "Br"}  # organic-subset two-letter symbols


class SmilesParseError(ValueError):
    pass


def parse_smiles(smiles: str, keep_h: bool = False, add_h: bool = False,
                 strict: bool = True) -> Optional[Molecule]:
    """Parse a SMILES string into a perceived Molecule.

    :param keep_h: keep explicit ``[H]`` atoms as graph nodes instead of
        folding them into heavy-atom H counts (reference make_mol keep-H path,
        chemprop/rdkit.py:13-16).
    :param add_h: materialize implicit hydrogens as graph nodes
        (``Chem.AddHs`` equivalent).
    :returns: the Molecule, or ``None`` when parsing fails and ``strict`` is
        False (mirrors ``MolFromSmiles`` returning None for invalid input).
    """
    try:
        mol = _parse(smiles)
        if not keep_h:
            _fold_explicit_hs(mol)
        mol.perceive(strict=True)
        if add_h:
            _materialize_hs(mol)
        return mol
    except Exception:
        if strict:
            raise
        return None


def _parse(s: str) -> Molecule:
    mol = Molecule()
    i = 0
    n = len(s)
    prev_atom: Optional[int] = None
    pending_bond: Optional[str] = None
    stack: List[Tuple[Optional[int], Optional[str]]] = []
    ring_openings: Dict[int, Tuple[int, Optional[str]]] = {}
    # semantic neighbour order per atom for chirality parity: entries are
    # neighbour atom ids, "H" (bracket hydrogen), or ("ring", num)
    # placeholders resolved at closure. SMILES chirality refers to this
    # written order; the molecule's bond-list order differs (ring closures
    # attach late), so the parity difference must flip @/@@ accordingly.
    sem_order: Dict[int, list] = {}

    def close_or_open_ring(num: int, bond_sym: Optional[str]) -> None:
        nonlocal pending_bond
        if prev_atom is None:
            raise SmilesParseError(f"ring digit before any atom in {s!r}")
        if num in ring_openings:
            a_open, sym_open = ring_openings.pop(num)
            sym = bond_sym or sym_open
            order, direction, aromatic = _decode_bond(sym, a_open, prev_atom)
            if order is None:
                a1, a2 = mol.atoms[a_open], mol.atoms[prev_atom]
                if a1.is_aromatic and a2.is_aromatic:
                    order, aromatic = AROMATIC, True
                else:
                    order = SINGLE
            if a_open == prev_atom:
                raise SmilesParseError(f"ring closure to same atom in {s!r}")
            # direction marker on a closure bond is oriented opening->closing
            if sym_open in ("/", "\\") and bond_sym is None:
                pass  # direction already encoded from the opening symbol
            mol.add_bond(a_open, prev_atom, order, is_aromatic=aromatic,
                         direction=direction)
            # resolve the opener's placeholder; record at closure position
            so = sem_order.get(a_open)
            if so is not None:
                for k, entry in enumerate(so):
                    if entry == ("ring", num):
                        so[k] = prev_atom
                        break
            sem_order.setdefault(prev_atom, []).append(a_open)
        else:
            ring_openings[num] = (prev_atom, bond_sym)
            sem_order.setdefault(prev_atom, []).append(("ring", num))

    def _decode_bond(sym: Optional[str], a1: int, a2: int):
        if sym is None:
            return None, 0, False
        if sym == ":":
            return AROMATIC, 0, True
        direction = 1 if sym == "/" else (-1 if sym == "\\" else 0)
        return _BOND_ORDERS[sym], direction, False

    def attach(new_atom: int) -> None:
        nonlocal prev_atom, pending_bond
        if prev_atom is not None:
            order, direction, aromatic = _decode_bond(pending_bond, prev_atom, new_atom)
            if order is None:
                a1, a2 = mol.atoms[prev_atom], mol.atoms[new_atom]
                if a1.is_aromatic and a2.is_aromatic:
                    order, aromatic = AROMATIC, True
                else:
                    order = SINGLE
            mol.add_bond(prev_atom, new_atom, order, is_aromatic=aromatic,
                         direction=direction)
            sem_order.setdefault(prev_atom, []).append(new_atom)
            so = sem_order.setdefault(new_atom, [])
            so.append(prev_atom)
        # bracket hydrogen occupies the slot right after the preceding atom
        # (it is written inside the brackets, before any ring digit/branch)
        if mol.atoms[new_atom].chiral_tag and mol.atoms[new_atom].explicit_hs:
            sem_order.setdefault(new_atom, []).append("H")
        prev_atom = new_atom
        pending_bond = None

    while i < n:
        c = s[i]
        if c in "-=#:$/\\":
            if pending_bond is not None:
                raise SmilesParseError(f"two bond symbols in a row in {s!r}")
            pending_bond = c
            i += 1
        elif c == "(":
            stack.append((prev_atom, pending_bond))
            pending_bond = None
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesParseError(f"unmatched ')' in {s!r}")
            prev_atom, pending_bond = stack.pop()
            i += 1
        elif c == ".":
            prev_atom = None
            pending_bond = None
            i += 1
        elif c == "%":
            if i + 2 >= n or not s[i + 1: i + 3].isdigit():
                raise SmilesParseError(f"bad %ring closure in {s!r}")
            close_or_open_ring(int(s[i + 1: i + 3]), pending_bond)
            pending_bond = None
            i += 3
        elif c.isdigit():
            close_or_open_ring(int(c), pending_bond)
            pending_bond = None
            i += 1
        elif c == "[":
            j = s.find("]", i)
            if j < 0:
                raise SmilesParseError(f"unclosed bracket in {s!r}")
            atom = _parse_bracket(s[i + 1: j])
            attach(mol.add_atom(atom))
            i = j + 1
        elif c == "*":
            attach(mol.add_atom(Atom(atomic_num=0, explicit_hs=0)))
            i += 1
        else:
            # organic-subset atom (possibly two letters)
            sym = None
            if s[i: i + 2] in _TWO_LETTER:
                sym = s[i: i + 2]
                i += 2
            elif c.upper() in ORGANIC_SUBSET or c in AROMATIC_ORGANIC:
                sym = c
                i += 1
            else:
                raise SmilesParseError(f"unexpected character {c!r} in {s!r}")
            aromatic = sym.islower()
            upper = sym[0].upper() + sym[1:]
            num = SYMBOL_TO_NUM[upper]
            attach(mol.add_atom(Atom(atomic_num=num, is_aromatic=aromatic)))

    if ring_openings:
        raise SmilesParseError(f"unclosed ring bond(s) {sorted(ring_openings)} in {s!r}")
    if stack:
        raise SmilesParseError(f"unclosed branch in {s!r}")
    if mol.n_atoms == 0:
        raise SmilesParseError("empty SMILES")
    _normalize_chirality(mol, sem_order)
    return mol


def _perm_parity(seq_from: list, seq_to: list) -> int:
    """Parity (0 even / 1 odd) of the permutation mapping seq_from onto
    seq_to (sequences over the same distinct elements)."""
    pos = {v: i for i, v in enumerate(seq_to)}
    perm = [pos[v] for v in seq_from]
    parity = 0
    seen = [False] * len(perm)
    for i in range(len(perm)):
        if seen[i]:
            continue
        j, clen = i, 0
        while not seen[j]:
            seen[j] = True
            j = perm[j]
            clen += 1
        parity ^= (clen - 1) & 1
    return parity


def _normalize_chirality(mol: Molecule, sem_order: Dict[int, list]) -> None:
    """Re-express parsed @/@@ tags relative to the molecule's bond-list
    neighbour order (implicit/bracket H last). SMILES chirality refers to
    the WRITTEN neighbour order; ring-closure bonds join the bond list at
    closure time, so the two orders differ by a permutation whose parity
    must flip the tag. Without this, identical 3D configurations written
    differently would get different tags (internally inconsistent features).
    """
    from .mol import CHI_TETRAHEDRAL_CCW, CHI_TETRAHEDRAL_CW
    for atom in mol.atoms:
        if atom.chiral_tag not in (CHI_TETRAHEDRAL_CW, CHI_TETRAHEDRAL_CCW):
            continue
        written = list(sem_order.get(atom.idx, []))
        mol_order = [b.other(atom.idx) for b in mol.atom_bonds(atom.idx)]
        if atom.explicit_hs:
            mol_order.append("H")
        if len(written) != len(mol_order) or len(written) not in (3, 4) \
                or set(map(str, written)) != set(map(str, mol_order)):
            continue  # degenerate; leave tag as parsed
        if _perm_parity(written, mol_order):
            atom.chiral_tag = (CHI_TETRAHEDRAL_CW
                               if atom.chiral_tag == CHI_TETRAHEDRAL_CCW
                               else CHI_TETRAHEDRAL_CCW)


def _parse_bracket(body: str) -> Atom:
    """Parse the inside of a bracket atom: isotope symbol chiral hcount charge :map."""
    i = 0
    n = len(body)
    isotope = 0
    while i < n and body[i].isdigit():
        isotope = isotope * 10 + int(body[i])
        i += 1
    if i >= n:
        raise SmilesParseError(f"bad bracket atom [{body}]")
    # element symbol (or aromatic lowercase, or wildcard)
    aromatic = False
    if body[i] == "*":
        num = 0
        i += 1
    else:
        if i + 1 < n and body[i: i + 2] in SYMBOL_TO_NUM and body[i].isupper():
            sym = body[i: i + 2]
            i += 2
        elif body[i].isupper():
            sym = body[i]
            i += 1
        elif body[i].islower():  # aromatic element in bracket, may be 2 letters (se, as)
            if i + 1 < n and (body[i] + body[i + 1]).islower() and \
                    (body[i].upper() + body[i + 1]) in SYMBOL_TO_NUM and \
                    body[i + 1] not in "hrl":  # avoid eating H/ring chars
                sym = body[i] + body[i + 1]
                i += 2
            else:
                sym = body[i]
                i += 1
            aromatic = True
            sym = sym[0].upper() + sym[1:]
        else:
            raise SmilesParseError(f"bad element in [{body}]")
        if sym not in SYMBOL_TO_NUM:
            raise SmilesParseError(f"unknown element {sym!r} in [{body}]")
        num = SYMBOL_TO_NUM[sym]
    chiral = 0
    if i < n and body[i] == "@":
        if i + 1 < n and body[i + 1] == "@":
            chiral = CHI_TETRAHEDRAL_CW
            i += 2
        else:
            chiral = CHI_TETRAHEDRAL_CCW
            i += 1
        # tolerate @TH1/@TH2 style
        while i < n and body[i].isupper() and body[i] not in "H":
            i += 1
    hcount = 0
    if i < n and body[i] == "H":
        i += 1
        hcount = 1
        num_str = ""
        while i < n and body[i].isdigit():
            num_str += body[i]
            i += 1
        if num_str:
            hcount = int(num_str)
    charge = 0
    while i < n and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        num_str = ""
        while i < n and body[i].isdigit():
            num_str += body[i]
            i += 1
        if num_str:
            charge += sign * int(num_str)
        else:
            charge += sign
    atom_map = 0
    if i < n and body[i] == ":":
        i += 1
        num_str = ""
        while i < n and body[i].isdigit():
            num_str += body[i]
            i += 1
        if not num_str:
            raise SmilesParseError(f"bad atom map in [{body}]")
        atom_map = int(num_str)
    if i != n:
        raise SmilesParseError(f"trailing characters in [{body}]")
    atom = Atom(atomic_num=num, formal_charge=charge, is_aromatic=aromatic,
                chiral_tag=chiral, isotope=isotope, explicit_hs=hcount)
    if atom_map:
        atom.props["atom_map"] = atom_map
    return atom


def _fold_explicit_hs(mol: Molecule) -> None:
    """Fold explicit [H] atoms bonded to a single heavy atom into H counts
    (what RDKit's default sanitize+removeHs does on MolFromSmiles)."""
    while True:
        target = None
        for a in mol.atoms:
            if a.atomic_num == 1 and a.isotope == 0 and a.formal_charge == 0 \
                    and mol.degree(a.idx) == 1:
                b = mol.atom_bonds(a.idx)[0]
                if b.order == SINGLE:
                    nb = mol.atoms[b.other(a.idx)]
                    if nb.atomic_num > 1:
                        target = (a.idx, nb.idx)
                        break
        if target is None:
            return
        h_idx, heavy_idx = target
        heavy = mol.atoms[heavy_idx]
        # Organic-subset atoms (explicit_hs None) recompute implicit Hs from
        # the valence model after the H atom is removed, which restores the
        # folded H automatically. Bracket atoms carry an explicit count that
        # must absorb the removed neighbour.
        if heavy.explicit_hs is not None:
            heavy.explicit_hs += 1
        mol.remove_atom(h_idx)
        # loop restarts: remove_atom compacts indices


def _materialize_hs(mol: Molecule) -> None:
    """AddHs equivalent: turn implicit hydrogens into explicit graph atoms."""
    for a in list(mol.atoms):
        nh = a.num_hs
        for _ in range(nh):
            h = mol.add_atom(Atom(atomic_num=1, explicit_hs=0))
            mol.add_bond(a.idx, h, SINGLE)
        a.explicit_hs = 0
        a.num_hs = 0
    mol.perceive()
