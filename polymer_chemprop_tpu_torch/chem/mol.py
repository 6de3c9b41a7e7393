"""Molecule model with perception algorithms (rings, aromaticity, kekulization,
implicit hydrogens, hybridization, conjugation).

This is the port's copy of the framework's replacement for the RDKit C++ chemistry core the
reference leans on (reference: chemprop/rdkit.py, featurization.py:190-250 use
``Chem.Atom``/``Chem.Bond`` accessors). Everything the featurizer needs —
GetTotalDegree / GetTotalNumHs / GetHybridization / GetIsAromatic / GetMass /
GetBondType / GetIsConjugated / IsInRing / GetStereo equivalents — is computed
here from first principles.

Perception pipeline (see :meth:`Molecule.perceive`):
  1. explicit-H folding (``[H]`` neighbours merged into H counts, as RDKit's
     sanitize+removeHs does)
  2. ring membership via bridge finding (an edge is "in a ring" iff it is not
     a bridge)
  3. aromaticity perception on candidate rings (Hückel 4n+2 over the ring
     cycle basis) for Kekulé-form inputs
  4. kekulization of aromatic systems via backtracking perfect matching
  5. implicit-H assignment from the valence model
  6. hybridization from steric number, conjugation from pi-adjacency
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .periodic import (
    atomic_mass,
    default_valence,
    outer_electrons,
)

# Bond orders (match RDKit's BondType semantics used by the reference
# featurizer, featurization.py:240-245).
SINGLE = 1
DOUBLE = 2
TRIPLE = 3
AROMATIC = 12  # sentinel; resolved to 1/2 by kekulization for valence math

# Chiral tags (RDKit ChiralType ints: featurization.py:204 uses int(GetChiralTag()))
CHI_UNSPECIFIED = 0
CHI_TETRAHEDRAL_CW = 1   # '@@'
CHI_TETRAHEDRAL_CCW = 2  # '@'
CHI_OTHER = 3

# Bond stereo (RDKit BondStereo ints: featurization.py:249 uses int(GetStereo()))
STEREONONE = 0
STEREOANY = 1
STEREOZ = 2
STEREOE = 3
STEREOCIS = 4
STEREOTRANS = 5


class KekulizationError(ValueError):
    """Raised when an aromatic system admits no Kekulé structure."""


@dataclass
class Atom:
    atomic_num: int
    formal_charge: int = 0
    is_aromatic: bool = False
    chiral_tag: int = CHI_UNSPECIFIED
    isotope: int = 0
    explicit_hs: Optional[int] = None  # from brackets; None = compute implicit
    idx: int = -1
    # computed by perception:
    num_hs: int = 0
    in_ring: bool = False
    hybridization: str = "SP3"
    # free-form properties (w_frag monomer weight, core/R polymer tags)
    props: dict = field(default_factory=dict)

    @property
    def mass(self) -> float:
        return atomic_mass(self.atomic_num, self.isotope)

    def is_wildcard(self) -> bool:
        return self.atomic_num == 0


@dataclass
class Bond:
    a1: int
    a2: int
    order: int  # SINGLE / DOUBLE / TRIPLE / AROMATIC
    idx: int = -1
    is_aromatic: bool = False
    # SMILES direction markers '/'=1, '\\'=-1 (0 = none), oriented a1->a2
    direction: int = 0
    # computed by perception:
    in_ring: bool = False
    conjugated: bool = False
    stereo: int = STEREONONE
    kekule_order: int = SINGLE  # resolved order after kekulization

    def other(self, a: int) -> int:
        return self.a2 if a == self.a1 else self.a1


class Molecule:
    """A molecular graph; append atoms/bonds then call :meth:`perceive`."""

    def __init__(self) -> None:
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: List[List[int]] = []  # atom idx -> list of bond indices
        self._bond_lookup: Dict[Tuple[int, int], int] = {}

    # ------------------------------------------------------------- building
    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        self._adj.append([])
        return atom.idx

    def add_bond(self, a1: int, a2: int, order: int, is_aromatic: bool = False,
                 direction: int = 0) -> int:
        if a1 == a2:
            raise ValueError("self-bond")
        key = (min(a1, a2), max(a1, a2))
        if key in self._bond_lookup:
            raise ValueError(f"duplicate bond {a1}-{a2}")
        bond = Bond(a1=a1, a2=a2, order=order, is_aromatic=is_aromatic,
                    direction=direction)
        bond.idx = len(self.bonds)
        self.bonds.append(bond)
        self._adj[a1].append(bond.idx)
        self._adj[a2].append(bond.idx)
        self._bond_lookup[key] = bond.idx
        return bond.idx

    def remove_atom(self, idx: int) -> None:
        """Remove an atom and its bonds; compacts indices (like RWMol.RemoveAtom)."""
        keep = [a for a in self.atoms if a.idx != idx]
        old_bonds = [b for b in self.bonds if b.a1 != idx and b.a2 != idx]
        remap = {}
        for new_i, a in enumerate(keep):
            remap[a.idx] = new_i
        self.atoms = []
        self.bonds = []
        self._adj = []
        self._bond_lookup = {}
        for a in keep:
            a.idx = -1
            self.add_atom(a)
        for b in old_bonds:
            self.add_bond(remap[b.a1], remap[b.a2], b.order,
                          is_aromatic=b.is_aromatic, direction=b.direction)

    # ------------------------------------------------------------ accessors
    def bond_between(self, a1: int, a2: int) -> Optional[Bond]:
        i = self._bond_lookup.get((min(a1, a2), max(a1, a2)))
        return self.bonds[i] if i is not None else None

    def neighbors(self, a: int) -> List[int]:
        return [self.bonds[bi].other(a) for bi in self._adj[a]]

    def atom_bonds(self, a: int) -> List[Bond]:
        return [self.bonds[bi] for bi in self._adj[a]]

    def degree(self, a: int) -> int:
        """Heavy-atom degree (wildcards count; implicit Hs do not)."""
        return len(self._adj[a])

    def total_degree(self, a: int) -> int:
        """RDKit GetTotalDegree equivalent: neighbours including hydrogens."""
        return self.degree(a) + self.atoms[a].num_hs

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)

    @property
    def n_bonds(self) -> int:
        return len(self.bonds)

    # ----------------------------------------------------------- perception
    def perceive(self, strict: bool = True) -> "Molecule":
        self._cleanup_hypervalent_nitrogen()
        self._perceive_rings()
        self._perceive_aromaticity()
        self._kekulize(strict=strict)
        self._reperceive_aromaticity()
        self._assign_implicit_hs()
        self._assign_hybridization()
        self._assign_conjugation()
        # CIP-based E/Z + non-stereocenter tag clearing (RDKit
        # AssignStereochemistry(cleanIt=True) equivalent)
        from .stereo import assign_stereochemistry
        assign_stereochemistry(self)
        return self

    def _cleanup_hypervalent_nitrogen(self) -> None:
        """RDKit ``MolOps::cleanUp`` equivalent for nitrogen.

        SMILES written with hypervalent neutral N — nitro ``N(=O)=O``,
        N-oxide ``n=O`` / ``N(=O)`` with 4 bonds, azide ``N=N=N`` — are
        normalized to the charge-separated forms RDKit produces on
        sanitization (``[N+](=O)[O-]``, ``[n+][O-]``, ``N=[N+]=[N-]``).
        The reference featurizer sees the sanitized charges
        (featurization.py:190-211 one-hots GetFormalCharge), so parity
        requires the same normalization here."""
        for atom in self.atoms:
            if atom.atomic_num != 7 or atom.formal_charge != 0:
                continue
            bos = 0.0
            for b in self.atom_bonds(atom.idx):
                bos += 1.5 if b.order == AROMATIC else b.order
            bos += atom.explicit_hs or 0
            if bos <= 3:
                continue
            # prefer separating a terminal =O (nitro / N-oxide): the
            # double bond becomes single and O takes the negative charge
            done = False
            for b in self.atom_bonds(atom.idx):
                o = self.atoms[b.other(atom.idx)]
                if (b.order == DOUBLE and o.atomic_num == 8
                        and o.formal_charge == 0
                        and len(self._adj[o.idx]) == 1):
                    b.order = SINGLE
                    o.formal_charge = -1
                    atom.formal_charge = 1
                    done = True
                    break
            if done:
                continue
            # azide-style: keep the double bond, move charges
            # (N=N=N -> N=[N+]=[N-])
            for b in self.atom_bonds(atom.idx):
                o = self.atoms[b.other(atom.idx)]
                if (b.order == DOUBLE and o.atomic_num == 7
                        and o.formal_charge == 0
                        and len(self._adj[o.idx]) == 1):
                    o.formal_charge = -1
                    atom.formal_charge = 1
                    break

    # ring membership: an edge is in a ring iff it is not a bridge.
    def _perceive_rings(self) -> None:
        n = self.n_atoms
        disc = [-1] * n
        low = [0] * n
        timer = [0]
        is_bridge = [False] * self.n_bonds

        for root in range(n):
            if disc[root] != -1:
                continue
            # iterative DFS to avoid recursion limits on long chains
            stack = [(root, -1, iter(self._adj[root]))]
            disc[root] = low[root] = timer[0]
            timer[0] += 1
            while stack:
                u, parent_edge, it = stack[-1]
                advanced = False
                for bi in it:
                    if bi == parent_edge:
                        continue
                    v = self.bonds[bi].other(u)
                    if disc[v] == -1:
                        disc[v] = low[v] = timer[0]
                        timer[0] += 1
                        stack.append((v, bi, iter(self._adj[v])))
                        advanced = True
                        break
                    else:
                        low[u] = min(low[u], disc[v])
                if not advanced:
                    stack.pop()
                    if stack:
                        p = stack[-1][0]
                        low[p] = min(low[p], low[u])
                        if low[u] > disc[p]:
                            is_bridge[parent_edge] = True

        for b in self.bonds:
            b.in_ring = not is_bridge[b.idx]
        for a in self.atoms:
            a.in_ring = any(self.bonds[bi].in_ring for bi in self._adj[a.idx])

    def ring_bonds_of(self, a: int) -> List[Bond]:
        return [b for b in self.atom_bonds(a) if b.in_ring]

    def sssr(self) -> List[List[int]]:
        """Smallest rings (cycle basis from BFS trees, one per ring bond class).

        Good enough for aromaticity perception of Kekulé-form input; inputs
        written in aromatic (lowercase) form never reach this code path.
        """
        rings: List[List[int]] = []
        seen_sets = set()
        ring_bond_ids = [b.idx for b in self.bonds if b.in_ring]
        covered = set()
        # BFS shortest cycle through each ring bond
        for bi in ring_bond_ids:
            if bi in covered:
                continue
            b = self.bonds[bi]
            # shortest path a1->a2 avoiding bond bi
            ring = self._shortest_cycle_through(b)
            if ring is None:
                continue
            key = frozenset(ring)
            if key not in seen_sets:
                seen_sets.add(key)
                rings.append(ring)
                for i in range(len(ring)):
                    bb = self.bond_between(ring[i], ring[(i + 1) % len(ring)])
                    if bb is not None:
                        covered.add(bb.idx)
        return rings

    def symm_sssr(self) -> List[List[int]]:
        """Symmetrized SSSR (RDKit ``GetSymmSSSR`` semantics).

        The plain SSSR drops symmetry-equivalent rings (bicyclo[2.2.2]octane
        keeps 2 of its 3 six-rings); RDKit's RingInfo — which backs the
        RingCount/ring-class descriptors and the SMARTS R/r primitives —
        re-adds every ring that is a *smallest* cycle through some ring
        bond.  We therefore collect all distinct minimum-length cycles
        through each ring bond (ties included)."""
        rings: List[List[int]] = []
        seen = set()
        for b in self.bonds:
            if not b.in_ring:
                continue
            for ring in self._all_shortest_cycles_through(b):
                key = frozenset(ring)
                if key not in seen:
                    seen.add(key)
                    rings.append(ring)
        return rings

    def _all_shortest_cycles_through(self, bond: Bond) -> List[List[int]]:
        """All minimum-length cycles containing ``bond`` (BFS over ring
        bonds from a1 to a2 avoiding the bond itself, keeping every
        shortest predecessor)."""
        from collections import deque
        src, dst = bond.a1, bond.a2
        dist = {src: 0}
        preds: Dict[int, List[int]] = {src: []}
        q = deque([src])
        while q:
            u = q.popleft()
            if u == dst:
                break
            for nb in self.atom_bonds(u):
                if nb.idx == bond.idx or not nb.in_ring:
                    continue
                v = nb.other(u)
                if v not in dist:
                    dist[v] = dist[u] + 1
                    preds[v] = [u]
                    q.append(v)
                elif dist[v] == dist[u] + 1:
                    preds[v].append(u)
        if dst not in dist:
            return []
        out: List[List[int]] = []
        # dense polycyclic cages (fullerene-like) can have combinatorially
        # many shortest paths through a bond; cap the enumeration and fall
        # back to a single shortest cycle beyond it (plain-SSSR behavior)
        MAX_CYCLES = 256
        steps = [0]
        capped = [False]

        def walk(u, path):
            if len(out) >= MAX_CYCLES or steps[0] > 100_000:
                capped[0] = True
                return
            steps[0] += 1
            if u == src:
                out.append(list(reversed(path)))
                return
            for p in preds[u]:
                if p in path:
                    continue
                path.append(p)
                walk(p, path)
                path.pop()
        walk(dst, [dst])
        if capped[0] or not out:
            # a truncated enumeration would be an arbitrary, walk-order-
            # dependent prefix — discard it and use the deterministic
            # single shortest cycle instead (plain-SSSR behavior, same
            # as the native featurizer's SSSR-lite)
            one = self._shortest_cycle_through(bond)
            return [one] if one else []
        return out

    def _shortest_cycle_through(self, bond: Bond) -> Optional[List[int]]:
        from collections import deque
        src, dst = bond.a1, bond.a2
        prev = {src: None}
        q = deque([src])
        while q:
            u = q.popleft()
            if u == dst:
                path = []
                while u is not None:
                    path.append(u)
                    u = prev[u]
                return path
            for nb in self.atom_bonds(u):
                if nb.idx == bond.idx or not nb.in_ring:
                    continue
                v = nb.other(u)
                if v not in prev:
                    prev[v] = u
                    q.append(v)
        return None

    # --- aromaticity perception (only needed for Kekulé-form input rings) ---
    def _pi_electrons_in_ring(self, a: int, ring: set) -> Optional[int]:
        """Electrons atom contributes to an aromatic pi system, or None if sp3-like."""
        atom = self.atoms[a]
        if atom.is_wildcard():
            return 0
        # an aromatic ring member needs a free p orbital: sigma framework
        # must fit sp2 (<= 3 connections). Excludes sulfone S(=O)(=O) in
        # rings (sigma 4) that a naive electron count would admit.
        if self.degree(a) + atom.num_hs > 3:
            return None
        dbl_in = dbl_out = 0
        for b in self.atom_bonds(a):
            if b.order == TRIPLE:
                return None
            if b.order == DOUBLE or b.order == AROMATIC:
                if b.other(a) in ring:
                    dbl_in += 1
                else:
                    dbl_out += 1
        if dbl_in >= 1:
            return 1  # part of an endocyclic double bond
        if dbl_out >= 1:
            # exocyclic double bond: contributes 0 (e.g. quinone carbonyl C)
            return 0
        # saturated ring atom: contributes a lone pair if it has one
        lp = self._lone_pairs(a)
        if lp > 0:
            return 2
        if atom.atomic_num == 6 and atom.formal_charge == 1:
            return 0  # tropylium-type cation
        if atom.atomic_num == 6 and atom.formal_charge == -1:
            return 2  # cyclopentadienide
        return None  # sp3 carbon -> ring can't be aromatic

    def _lone_pairs(self, a: int, kekulized: bool = False) -> int:
        atom = self.atoms[a]
        if atom.atomic_num == 0:
            return 0
        bo = atom.num_hs
        for b in self.atom_bonds(a):
            if kekulized and b.order == AROMATIC:
                bo += b.kekule_order
            else:
                bo += 1 if b.order in (SINGLE, AROMATIC) else b.order
        ve = outer_electrons(atom.atomic_num) - atom.formal_charge
        return max(0, (ve - bo) // 2)

    def _ring_bond_ids(self, ring: List[int]) -> List[int]:
        out = []
        for i, a in enumerate(ring):
            b = self.bond_between(a, ring[(i + 1) % len(ring)])
            if b is not None:
                out.append(b.idx)
        return out

    def _electron_donor(self, a: int) -> Optional[int]:
        """RDKit-style static pi-electron donor type of an atom on the
        kekulized structure (Aromaticity.cpp getAtomDonorTypeArom):

        * multiple bond in a ring (ANY ring — this is what lets ring B of
          Kekulé naphthalene count its fusion atoms): 1 electron
        * exocyclic (non-ring) double bond to a heteroatom: 0 (vacant —
          quinone / pyridinone / actinomycin carbonyl carbons)
        * exocyclic double bond to carbon: None (blocker — fulvene)
        * lone-pair bearer (pyrrole N, furan O, thiophene S): 2
        * carbocation 0, carbanion 2; anything sp3-like: None (blocker)
        """
        atom = self.atoms[a]
        if atom.is_wildcard():
            return 0
        if self.degree(a) + atom.num_hs > 3:
            return None
        cyc_mult = exo_dbl_het = exo_dbl_c = 0
        for b in self.atom_bonds(a):
            order = b.kekule_order if b.order == AROMATIC else b.order
            if order in (DOUBLE, TRIPLE):
                if b.in_ring:
                    cyc_mult += 1
                elif self.atoms[b.other(a)].atomic_num == 6:
                    exo_dbl_c += 1
                else:
                    exo_dbl_het += 1
        if exo_dbl_c:
            return None
        if cyc_mult:
            return 1
        if exo_dbl_het:
            return 0
        lp = self._lone_pairs(a, kekulized=True)
        if lp > 0:
            return 2
        if atom.atomic_num == 6 and atom.formal_charge == 1:
            return 0
        if atom.atomic_num == 6 and atom.formal_charge == -1:
            return 2
        return None

    def _huckel_kekule(self, rings: List[List[int]]):
        """RDKit-style aromaticity over candidate rings of the kekulized
        structure: per-ring Hückel 4n+2 over the static donor counts, then
        unions of the remaining fused failed rings (azulene-type systems
        that only satisfy 4n+2 jointly). Unions exclude individually
        -aromatic rings and reject any union containing a vacant (0
        -electron) donor: both exclusions are what keeps the phenoxazinone
        tricycle of actinomycin D at ONE aromatic ring (benzo) instead of
        rescuing quinonoid+oxazine through a whole-system electron count.
        Returns (aromatic_atom_ids, aromatic_bond_ids)."""
        donors = {}
        for ring in rings:
            for a in ring:
                if a not in donors:
                    donors[a] = self._electron_donor(a)
        arom_atoms: set = set()
        arom_bonds: set = set()

        def accept(ring_list):
            for ring in ring_list:
                arom_atoms.update(ring)
                arom_bonds.update(self._ring_bond_ids(ring))

        pending = []
        for ring in rings:
            pis = [donors[a] for a in ring]
            if any(p is None for p in pis):
                continue  # blocked ring: never aromatic, never in unions
            if sum(pis) % 4 == 2:
                accept([ring])
            else:
                pending.append(ring)
        # union rescue over the failed candidate rings
        if pending:
            from itertools import combinations
            rbonds = [set(self._ring_bond_ids(r)) for r in pending]
            done = set()
            for size in (2, 3, 4):
                if len(pending) < size:
                    break
                for combo in combinations(range(len(pending)), size):
                    if done & set(combo):
                        continue
                    # require the combo to be connected via shared bonds
                    grown = {combo[0]}
                    rest = set(combo[1:])
                    grew = True
                    while grew and rest:
                        grew = False
                        for j in list(rest):
                            if any(rbonds[j] & rbonds[k] for k in grown):
                                grown.add(j)
                                rest.remove(j)
                                grew = True
                    if rest:
                        continue
                    union = set()
                    for j in combo:
                        union.update(pending[j])
                    pis = [donors[a] for a in union]
                    if any(p == 0 for p in pis):
                        continue  # vacant donor blocks union rescue
                    if sum(pis) % 4 == 2:
                        accept([pending[j] for j in combo])
                        done.update(combo)
        return arom_atoms, arom_bonds

    def _perceive_aromaticity(self) -> None:
        # pre-assign rough H counts so lone-pair math works during perception
        self._assign_implicit_hs(prelim=True)
        candidate_rings = []
        for ring in self.sssr():
            if len(ring) < 5 or len(ring) > 7:
                continue
            rs = set(ring)
            pis = []
            ok = True
            for a in ring:
                pe = self._pi_electrons_in_ring(a, rs)
                if pe is None:
                    ok = False
                    break
                pis.append(pe)
            if not ok:
                continue
            total = sum(pis)
            if total % 4 == 2:  # Hückel 4n+2
                candidate_rings.append(ring)
        for ring in candidate_rings:
            rs = set(ring)
            for a in ring:
                self.atoms[a].is_aromatic = True
            for i, a in enumerate(ring):
                b = self.bond_between(a, ring[(i + 1) % len(ring)])
                if b is not None:
                    b.is_aromatic = True
                    if b.order in (SINGLE, DOUBLE):
                        b.order = AROMATIC

    def _reperceive_aromaticity(self) -> None:
        """Authoritative post-kekulization perception (the re-perception
        RDKit sanitization performs after parsing): recompute aromaticity
        from the Kekulé structure and reconcile with the written flags —
        PROMOTE rings the pre-pass missed (Kekulé-written fused systems:
        naphthalene ring B, azulene) and DEMOTE written-aromatic rings the
        model rejects (e.g. 2 of the 3 phenoxazinone rings of actinomycin
        D — RDKit reports exactly 1 aromatic ring there). Only rings of
        size 5-7 (the model's scope) are touched; kekule_order is already
        assigned and is preserved, so H counts do not change."""
        rings = [r for r in self.sssr() if 5 <= len(r) <= 7]
        if not rings:
            return
        arom_atoms, arom_bonds = self._huckel_kekule(rings)
        scope_bonds = set()
        scope_atoms = set()
        for r in rings:
            scope_bonds.update(self._ring_bond_ids(r))
            scope_atoms.update(r)
        for bi in scope_bonds:
            b = self.bonds[bi]
            if bi in arom_bonds:
                if not b.is_aromatic:
                    b.is_aromatic = True
                    if b.order in (SINGLE, DOUBLE):
                        b.kekule_order = b.order
                        b.order = AROMATIC
            elif b.is_aromatic:
                b.is_aromatic = False
                if b.order == AROMATIC:
                    b.order = b.kekule_order
        for ai in scope_atoms:
            atom = self.atoms[ai]
            if ai in arom_atoms:
                atom.is_aromatic = True
            elif atom.is_aromatic:
                # keep the flag only if an out-of-scope aromatic bond
                # (macrocycle etc.) still touches the atom
                atom.is_aromatic = any(
                    b.is_aromatic for b in self.atom_bonds(ai))

    # --- kekulization: assign alternating double bonds on aromatic systems ---
    def _pi_role(self, a: int) -> Optional[str]:
        """'required' if the atom must take exactly one double bond in a
        Kekulé structure, 'optional' if it may take 0 or 1 (charged carbon:
        tropylium/cyclopentadienide), None if it contributes a lone pair or
        empty orbital only (o, s, [nH], n-oxide O side, wildcards)."""
        atom = self.atoms[a]
        if not atom.is_aromatic or atom.is_wildcard():
            return None
        valences = default_valence(atom.atomic_num, atom.formal_charge)
        if not valences:
            return None
        used = atom.num_hs  # preliminary H counts assigned before kekulization
        for b in self.atom_bonds(a):
            used += 1 if b.order == AROMATIC else b.order
        # smallest allowed valence that accommodates the sigma framework
        target = next((v for v in valences if v >= used), valences[-1])
        if target - used < 1:
            return None
        if atom.atomic_num == 6 and atom.formal_charge != 0:
            return "optional"
        return "required"

    def _kekulize(self, strict: bool = True) -> None:
        arom_bonds = [b for b in self.bonds if b.order == AROMATIC]
        for b in self.bonds:
            b.kekule_order = b.order if b.order != AROMATIC else SINGLE
        # NO early return when arom_bonds is empty: an aromatic atom that
        # needs a pi bond (role 'required') but has no aromatic bond at all
        # (e.g. lowercase n outside any ring, "CnC") must fail kekulization
        # exactly like RDKit's "non-ring atom marked aromatic" sanitize
        # error — the reference drops such SMILES as invalid.
        roles = {a.idx: self._pi_role(a.idx) for a in self.atoms if a.is_aromatic}
        required = [a for a, r in roles.items() if r == "required"]
        eligible = {a for a, r in roles.items() if r in ("required", "optional")}
        adj: Dict[int, List[Bond]] = {a: [] for a in eligible}
        for b in arom_bonds:
            if b.a1 in eligible and b.a2 in eligible:
                adj[b.a1].append(b)
                adj[b.a2].append(b)

        # Kekulé assignment = matching that saturates every 'required' atom.
        # Greedy augmenting paths (optional atoms may stay unmatched); the
        # final fallback is exhaustive backtracking, but aromatic systems in
        # practice are near-bipartite and augmenting alone succeeds.
        matched: Dict[int, int] = {}

        def try_augment(u: int, visited: set) -> bool:
            for b in adj.get(u, ()):
                v = b.other(u)
                if v in visited:
                    continue
                visited.add(v)
                if v not in matched or try_augment(matched[v], visited):
                    matched[u] = v
                    matched[v] = u
                    return True
            return False

        failed = []
        for u in sorted(required, key=lambda x: len(adj[x])):
            if u not in matched and not try_augment(u, {u}):
                failed.append(u)
        if failed:
            matched = self._kekulize_backtrack(required, adj)
            if matched is None:
                if strict:
                    raise KekulizationError(
                        f"cannot kekulize aromatic system around atom {failed[0]}")
                matched = {}
        for b in arom_bonds:
            if matched.get(b.a1) == b.a2:
                b.kekule_order = DOUBLE

    def _kekulize_backtrack(self, required, adj):
        required = [u for u in required]
        matched: Dict[int, int] = {}

        def solve(i: int) -> bool:
            while i < len(required) and required[i] in matched:
                i += 1
            if i == len(required):
                return True
            u = required[i]
            for b in adj.get(u, ()):
                v = b.other(u)
                if v in matched:
                    continue
                matched[u] = v
                matched[v] = u
                if solve(i + 1):
                    return True
                del matched[u]
                del matched[v]
            return False

        return matched if solve(0) else None

    # --- implicit hydrogens -------------------------------------------------
    def _bond_order_sum(self, a: int, kekulized: bool) -> float:
        s = 0.0
        for b in self.atom_bonds(a):
            if b.order == AROMATIC:
                s += b.kekule_order if kekulized else 1.5
            else:
                s += b.order
        return s

    def _assign_implicit_hs(self, prelim: bool = False) -> None:
        for atom in self.atoms:
            if atom.explicit_hs is not None:
                atom.num_hs = atom.explicit_hs
                continue
            if atom.is_wildcard():
                atom.num_hs = 0
                continue
            valences = default_valence(atom.atomic_num, atom.formal_charge)
            if not valences:
                atom.num_hs = 0
                continue
            if prelim:
                # before kekulization treat aromatic bonds as order 1 plus one
                # shared pi bond for pi-capable atoms (OpenSMILES heuristic)
                bo = sum(1 if b.order == AROMATIC else b.order
                         for b in self.atom_bonds(atom.idx))
                if atom.is_aromatic and self._needs_pi_preliminary(atom.idx):
                    bo += 1
            else:
                bo = self._bond_order_sum(atom.idx, kekulized=True)
            bo = int(round(bo))
            nh = 0
            for v in valences:
                if bo <= v:
                    nh = v - bo
                    break
            atom.num_hs = nh

    def _needs_pi_preliminary(self, a: int) -> bool:
        atom = self.atoms[a]
        valences = default_valence(atom.atomic_num, atom.formal_charge)
        if not valences:
            return False
        used = sum(1 if b.order == AROMATIC else b.order
                   for b in self.atom_bonds(a))
        if atom.explicit_hs is not None:
            used += atom.explicit_hs
        target = next((v for v in valences if v >= used), valences[-1])
        return (target - used) >= 1

    # --- hybridization ------------------------------------------------------
    def _assign_hybridization(self) -> None:
        for atom in self.atoms:
            a = atom.idx
            if atom.is_wildcard():
                atom.hybridization = "UNSPECIFIED"
                continue
            if atom.atomic_num == 1:
                atom.hybridization = "S"
                continue
            if not default_valence(atom.atomic_num, atom.formal_charge):
                # no valence model (metals etc.): RDKit reports S/UNSPECIFIED
                # -> unknown one-hot slot
                atom.hybridization = "UNSPECIFIED"
                continue
            if atom.is_aromatic:
                atom.hybridization = "SP2"
                continue
            # pure steric-number rule: sigma neighbours + lone pairs.
            # (No multiple-bond shortcuts: they misclassify hypervalent
            # S/N — sulfonamide S(=O)(=O) is SP3, nitro N(=O)=O is SP2.)
            sigma = self.degree(a) + atom.num_hs
            lp = self._lone_pairs(a)
            steric = sigma + lp
            if steric <= 2:
                atom.hybridization = "SP"
            elif steric == 3:
                atom.hybridization = "SP2"
            elif steric == 4:
                atom.hybridization = "SP3"
            elif steric == 5:
                atom.hybridization = "SP3D"
            else:
                atom.hybridization = "SP3D2"

    # --- conjugation --------------------------------------------------------
    def _pi_center(self, a: int) -> bool:
        """Atom that can take part in a conjugated system: carries a
        multiple/aromatic bond, or is a lone-pair-bearing heteroatom."""
        atom = self.atoms[a]
        if atom.is_wildcard():
            return False
        for b in self.atom_bonds(a):
            if b.order in (DOUBLE, TRIPLE, AROMATIC) or b.is_aromatic:
                return True
        return atom.atomic_num in (7, 8, 16, 15) and self._lone_pairs(a) > 0

    def _assign_conjugation(self) -> None:
        """RDKit-style pair marking: around every atom, a multiple/aromatic
        bond b1 and a sibling bond b2 whose far end is a pi center are both
        conjugated. Isolated multiple bonds (ethylene, acetone C=O) stay
        unconjugated; alternating systems, amides/esters, aryl links are
        marked (mirrors RDKit MolOps::setConjugation semantics)."""
        for b in self.bonds:
            b.conjugated = b.order == AROMATIC or b.is_aromatic
        for a in range(self.n_atoms):
            bonds = self.atom_bonds(a)
            if len(bonds) < 2:
                continue
            for b1 in bonds:
                if not (b1.order in (DOUBLE, TRIPLE, AROMATIC) or b1.is_aromatic):
                    continue
                for b2 in bonds:
                    if b2.idx == b1.idx:
                        continue
                    if self._pi_center(b2.other(a)):
                        b1.conjugated = True
                        b2.conjugated = True

    # --- double-bond stereo helpers (assignment lives in chem/stereo.py,
    # which uses CIP priorities; a '/' bond stored X->Y means Y sits "up"
    # relative to X, so the marked neighbour's side is +d when the axis atom
    # is the directional bond's source and -d when it is the target) -------
    def _directional_neighbor(self, a: int, skip_bond: int):
        for bb in self.atom_bonds(a):
            if bb.idx != skip_bond and bb.direction != 0 and bb.order == SINGLE:
                return bb.idx, bb.direction
        return None

    # --- misc ---------------------------------------------------------------
    def copy(self) -> "Molecule":
        m = Molecule()
        for a in self.atoms:
            m.add_atom(Atom(atomic_num=a.atomic_num, formal_charge=a.formal_charge,
                            is_aromatic=a.is_aromatic, chiral_tag=a.chiral_tag,
                            isotope=a.isotope, explicit_hs=a.explicit_hs,
                            props=dict(a.props)))
            na = m.atoms[-1]
            na.num_hs = a.num_hs
            na.in_ring = a.in_ring
            na.hybridization = a.hybridization
        for b in self.bonds:
            m.add_bond(b.a1, b.a2, b.order, is_aromatic=b.is_aromatic,
                       direction=b.direction)
            nb = m.bonds[-1]
            nb.in_ring = b.in_ring
            nb.conjugated = b.conjugated
            nb.stereo = b.stereo
            nb.kekule_order = b.kekule_order
        return m
