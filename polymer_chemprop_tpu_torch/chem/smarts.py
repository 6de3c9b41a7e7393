"""SMARTS pattern parser and substructure matcher.

The reference gets substructure queries for free through RDKit
(``mol.GetSubstructMatches`` backing ``Fragments.py`` fragment counts,
``Lipinski.py`` H-donor/acceptor counts, Crippen atom typing and the QED
structural alerts — all consumed by descriptastorus's ``rdkit_2d``
generator, reference features_generators.py:92-133).  This module is the
standalone equivalent on our own :class:`~polymer_chemprop_tpu_torch.chem.mol.
Molecule`: a recursive-descent SMARTS parser producing a query graph and
a backtracking (VF2-style) subgraph matcher.

Supported SMARTS surface (everything the descriptor tables in
``chem/descriptors/`` use):

* atom primitives: ``*  A  a``, organic-subset bare symbols (``C`` =
  aliphatic, ``c`` = aromatic), bracket atoms with element symbols /
  ``#n`` atomic number / isotope / ``D X x H h R r v`` counts / ``+ -``
  charges / ``@ @@`` (accepted, unconstrained) / atom maps ``:n``
* logical operators with Daylight precedence: ``!`` > ``&`` (and
  juxtaposition) > ``,`` > ``;``
* recursive SMARTS ``$(...)``
* bond primitives ``- = # : ~ @ / \\`` with the same logical operators;
  default bond is single-or-aromatic
* branches, ring closures (``%nn`` included)

Matching semantics mirror RDKit's ``GetSubstructMatches``: matches are
tuples of molecule atom indices in pattern-atom order; ``uniquify=True``
deduplicates matches covering the same atom set.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .mol import AROMATIC, Molecule
from .periodic import SYMBOL_TO_NUM

__all__ = ["SmartsPattern", "parse_smarts", "match_all", "count_matches",
           "has_match", "match_rooted"]


# ---------------------------------------------------------------------------
# query expression AST
# ---------------------------------------------------------------------------

class _Expr:
    __slots__ = ()

    def eval(self, ctx, idx):  # pragma: no cover - abstract
        raise NotImplementedError


class _True(_Expr):
    __slots__ = ()

    def eval(self, ctx, idx):
        return True


class _Not(_Expr):
    __slots__ = ("e",)

    def __init__(self, e):
        self.e = e

    def eval(self, ctx, idx):
        return not self.e.eval(ctx, idx)


class _And(_Expr):
    __slots__ = ("es",)

    def __init__(self, es):
        self.es = es

    def eval(self, ctx, idx):
        return all(e.eval(ctx, idx) for e in self.es)


class _Or(_Expr):
    __slots__ = ("es",)

    def __init__(self, es):
        self.es = es

    def eval(self, ctx, idx):
        return any(e.eval(ctx, idx) for e in self.es)


class _AtomPrim(_Expr):
    """A single atom primitive; ``kind`` selects the predicate."""
    __slots__ = ("kind", "val")

    def __init__(self, kind, val=None):
        self.kind = kind
        self.val = val

    def eval(self, ctx, idx):
        a = ctx.mol.atoms[idx]
        k = self.kind
        if k == "any":
            return True
        if k == "arom_any":
            return a.is_aromatic
        if k == "aliph_any":
            return not a.is_aromatic
        if k == "elem":          # element, aromaticity unconstrained
            return a.atomic_num == self.val
        if k == "elem_arom":
            return a.atomic_num == self.val and a.is_aromatic
        if k == "elem_aliph":
            return a.atomic_num == self.val and not a.is_aromatic
        if k == "charge":
            return a.formal_charge == self.val
        if k == "isotope":
            return a.isotope == self.val
        if k == "D":
            return ctx.mol.degree(idx) == self.val
        if k == "X":
            return ctx.mol.degree(idx) + a.num_hs == self.val
        if k == "Hcount":
            return a.num_hs == self.val
        if k == "hcount":        # implicit H; all our Hs are implicit
            return a.num_hs == self.val
        if k == "hany":
            return a.num_hs >= 1
        if k == "v":
            return ctx.valence(idx) == self.val
        if k == "Rany":
            return a.in_ring
        if k == "Rcount":
            return ctx.ring_count(idx) == self.val
        if k == "rany":
            return a.in_ring
        if k == "rsize":
            return self.val in ctx.ring_sizes(idx)
        if k == "xany":
            return ctx.ring_bond_count(idx) >= 1
        if k == "xcount":
            return ctx.ring_bond_count(idx) == self.val
        if k == "recursive":
            return ctx.recursive(self.val, idx)
        raise AssertionError(k)


class _BondPrim(_Expr):
    __slots__ = ("kind",)

    def __init__(self, kind):
        self.kind = kind

    def eval(self, ctx, bond):
        k = self.kind
        # RDKit semantics: a bond is AROMATIC only in a ring; a "single"
        # bond written between two aromatic atoms (biphenyl link) is SINGLE
        arom = (bond.is_aromatic or bond.order == AROMATIC) and bond.in_ring
        order = bond.kekule_order if bond.order == AROMATIC else bond.order
        if k == "any":
            return True
        if k == "single":
            return (not arom) and order == 1
        if k == "double":
            return (not arom) and order == 2
        if k == "triple":
            return (not arom) and order == 3
        if k == "aromatic":
            return arom
        if k == "ring":
            return bond.in_ring
        if k == "default":       # unspecified bond: single or aromatic
            return arom or order == 1
        raise AssertionError(k)


# ---------------------------------------------------------------------------
# parsed pattern
# ---------------------------------------------------------------------------

class SmartsPattern:
    def __init__(self, smarts: str):
        self.smarts = smarts
        self.atoms: List[_Expr] = []
        # (ai, aj, bond_expr)
        self.bonds: List[Tuple[int, int, _Expr]] = []
        self.adj: List[List[Tuple[int, int]]] = []   # atom -> [(nbr, bond_i)]

    def add_atom(self, expr: _Expr) -> int:
        self.atoms.append(expr)
        self.adj.append([])
        return len(self.atoms) - 1

    def add_bond(self, i: int, j: int, expr: _Expr) -> None:
        bi = len(self.bonds)
        self.bonds.append((i, j, expr))
        self.adj[i].append((j, bi))
        self.adj[j].append((i, bi))

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_TWO_LETTER = ("Cl", "Br", "Si", "Se", "As", "Na", "Ca", "Li", "Mg", "Al",
               "Zn", "Fe", "Cu", "Mn", "Sn", "Te", "Ge", "Sb", "Bi")
_AROM_ELEMS = {"b": 5, "c": 6, "n": 7, "o": 8, "p": 15, "s": 16,
               "se": 34, "as": 33}
_ORGANIC = {"B": 5, "C": 6, "N": 7, "O": 8, "P": 15, "S": 16, "F": 9,
            "Cl": 17, "Br": 35, "I": 53}


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    # -- low-level --------------------------------------------------------
    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def take(self) -> str:
        c = self.s[self.i]
        self.i += 1
        return c

    def number(self, default=None) -> Optional[int]:
        j = self.i
        while j < len(self.s) and self.s[j].isdigit():
            j += 1
        if j == self.i:
            return default
        v = int(self.s[self.i:j])
        self.i = j
        return v

    def error(self, msg):
        raise ValueError(f"SMARTS parse error at {self.i} in {self.s!r}: {msg}")

    # -- atom expression (inside brackets) --------------------------------
    def parse_bracket_atom(self) -> _Expr:
        # precedence: ';' (low AND) < ',' (OR) < '&'/juxtaposition < '!'
        self._seen_prim = False
        expr = self._low_and(self._atom_factor)
        if self.peek() != "]":
            self.error(f"expected ] got {self.peek()!r}")
        self.take()
        return expr

    def _low_and(self, factor, is_atom=True) -> _Expr:
        terms = [self._or(factor, is_atom)]
        while self.peek() == ";":
            self.take()
            terms.append(self._or(factor, is_atom))
        return terms[0] if len(terms) == 1 else _And(terms)

    def _or(self, factor, is_atom=True) -> _Expr:
        terms = [self._high_and(factor, is_atom)]
        while self.peek() == ",":
            self.take()
            terms.append(self._high_and(factor, is_atom))
        return terms[0] if len(terms) == 1 else _Or(terms)

    def _high_and(self, factor, is_atom=True) -> _Expr:
        terms = [self._not(factor)]
        while True:
            c = self.peek()
            if c == "&":
                self.take()
                terms.append(self._not(factor))
            elif is_atom and c and c not in ";,]":
                # juxtaposition inside brackets is AND
                terms.append(self._not(factor))
            elif (not is_atom) and c == "!":
                terms.append(self._not(factor))
            else:
                break
        return terms[0] if len(terms) == 1 else _And(terms)

    def _not(self, factor) -> _Expr:
        if self.peek() == "!":
            self.take()
            return _Not(self._not(factor))
        return factor()

    def _atom_factor(self) -> _Expr:
        c = self.peek()
        if c == "":
            self.error("unexpected end in bracket atom")
        # isotope (leading digits)
        if c.isdigit():
            n = self.number()
            self._seen_prim = True
            return _AtomPrim("isotope", n)
        if c == "$":
            self.take()
            if self.take() != "(":
                self.error("expected ( after $")
            depth = 1
            j = self.i
            while depth:
                ch = self.s[j]
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                j += 1
            sub = self.s[self.i:j - 1]
            self.i = j
            self._seen_prim = True
            return _AtomPrim("recursive", parse_smarts(sub))
        if c == "*":
            self.take()
            self._seen_prim = True
            return _AtomPrim("any")
        if c == "#":
            self.take()
            self._seen_prim = True
            return _AtomPrim("elem", self.number())
        if c == "+":
            self.take()
            n = self.number(None)
            if n is None:
                n = 1
                while self.peek() == "+":
                    self.take()
                    n += 1
            self._seen_prim = True
            return _AtomPrim("charge", n)
        if c == "-":
            self.take()
            n = self.number(None)
            if n is None:
                n = 1
                while self.peek() == "-":
                    self.take()
                    n += 1
            self._seen_prim = True
            return _AtomPrim("charge", -n)
        if c == "@":
            self.take()
            if self.peek() == "@":
                self.take()
            self.number(None)  # e.g. @TH1 not supported; digits tolerated
            return _True()
        if c == ":":
            self.take()
            self.number()
            return _True()
        # two-letter elements first
        for sym in _TWO_LETTER:
            if self.s.startswith(sym, self.i):
                self.i += len(sym)
                self._seen_prim = True
                return _AtomPrim("elem_aliph", SYMBOL_TO_NUM[sym])
        for sym in ("se", "as"):
            if self.s.startswith(sym, self.i):
                self.i += 2
                self._seen_prim = True
                return _AtomPrim("elem_arom", _AROM_ELEMS[sym])
        if c == "A":
            self.take()
            self._seen_prim = True
            return _AtomPrim("aliph_any")
        if c == "a":
            self.take()
            self._seen_prim = True
            return _AtomPrim("arom_any")
        if c in "DXxhRrv":
            kind = c
            self.take()
            n = self.number(None)
            if kind == "D":
                return _AtomPrim("D", 1 if n is None else n)
            if kind == "X":
                return _AtomPrim("X", 1 if n is None else n)
            if kind == "x":
                return (_AtomPrim("xany") if n is None
                        else _AtomPrim("xcount", n))
            if kind == "h":
                return (_AtomPrim("hany") if n is None
                        else _AtomPrim("hcount", n))
            if kind == "R":
                if n is None:
                    return _AtomPrim("Rany")
                if n == 0:
                    return _Not(_AtomPrim("Rany"))
                return _AtomPrim("Rcount", n)
            if kind == "r":
                return (_AtomPrim("rany") if n is None
                        else _AtomPrim("rsize", n))
            if kind == "v":
                return _AtomPrim("v", 1 if n is None else n)
        if c == "H":
            self.take()
            n = self.number(None)
            if not self._seen_prim and n is None:
                # [H...] leading H with no count = hydrogen element
                self._seen_prim = True
                return _AtomPrim("elem", 1)
            self._seen_prim = True
            return _AtomPrim("Hcount", 1 if n is None else n)
        if c.isupper():
            sym = self.take()
            if sym in SYMBOL_TO_NUM:
                self._seen_prim = True
                return _AtomPrim("elem_aliph", SYMBOL_TO_NUM[sym])
            self.error(f"unknown element {sym!r}")
        if c in _AROM_ELEMS:
            self.take()
            self._seen_prim = True
            return _AtomPrim("elem_arom", _AROM_ELEMS[c])
        self.error(f"unexpected {c!r} in bracket atom")

    # -- bond expression --------------------------------------------------
    _BOND_CHARS = "-=#:~@/\\!&,;"

    def _bond_factor(self) -> _Expr:
        c = self.peek()
        if c == "-":
            self.take()
            return _BondPrim("single")
        if c == "=":
            self.take()
            return _BondPrim("double")
        if c == "#":
            self.take()
            return _BondPrim("triple")
        if c == ":":
            self.take()
            return _BondPrim("aromatic")
        if c == "~":
            self.take()
            return _BondPrim("any")
        if c == "@":
            self.take()
            return _BondPrim("ring")
        if c in "/\\":
            self.take()
            return _BondPrim("single")
        self.error(f"unexpected bond char {c!r}")

    def parse_bond(self) -> Optional[_Expr]:
        """Parse a bond expression if present; None means default bond."""
        c = self.peek()
        if c == "" or c not in self._BOND_CHARS or c in ",;&":
            return None
        return self._low_and(self._bond_factor, is_atom=False)

    # -- full SMARTS ------------------------------------------------------
    def parse(self) -> SmartsPattern:
        pat = SmartsPattern(self.s)
        prev: Optional[int] = None
        stack: List[Optional[int]] = []
        ring: Dict[int, Tuple[int, Optional[_Expr]]] = {}
        while self.i < len(self.s):
            c = self.peek()
            if c == "(":
                self.take()
                stack.append(prev)
                continue
            if c == ")":
                self.take()
                prev = stack.pop()
                continue
            if c == ".":
                self.error("disconnected SMARTS components not supported")
            bond_expr = self.parse_bond()
            c = self.peek()
            if c == "%" or c.isdigit():
                if c == "%":
                    self.take()
                    num = int(self.take() + self.take())
                else:
                    num = int(self.take())
                if num in ring:
                    other, obond = ring.pop(num)
                    be = bond_expr if bond_expr is not None else obond
                    pat.add_bond(prev, other,
                                 be if be is not None else _BondPrim("default"))
                else:
                    ring[num] = (prev, bond_expr)
                continue
            # atom
            if c == "[":
                self.take()
                expr = self.parse_bracket_atom()
            elif c == "*":
                self.take()
                expr = _AtomPrim("any")
            elif c == "A":
                self.take()
                expr = _AtomPrim("aliph_any")
            elif c == "a":
                self.take()
                expr = _AtomPrim("arom_any")
            elif c in "bcnops":
                # aromatic organic subset (single letter)
                self.take()
                expr = _AtomPrim("elem_arom", _AROM_ELEMS[c])
            else:
                matched = None
                for sym in ("Cl", "Br"):
                    if self.s.startswith(sym, self.i):
                        matched = sym
                        self.i += 2
                        break
                if matched is None:
                    sym = self.take()
                    if sym not in _ORGANIC:
                        self.error(f"unexpected atom symbol {sym!r}")
                    matched = sym
                expr = _AtomPrim("elem_aliph", _ORGANIC[matched])
            ai = pat.add_atom(expr)
            if prev is not None:
                pat.add_bond(prev, ai,
                             bond_expr if bond_expr is not None
                             else _BondPrim("default"))
            elif bond_expr is not None:
                self.error("bond with no previous atom")
            prev = ai
        if ring:
            self.error(f"unclosed ring closures {sorted(ring)}")
        return pat


_PATTERN_CACHE: Dict[str, SmartsPattern] = {}


def parse_smarts(s: str) -> SmartsPattern:
    pat = _PATTERN_CACHE.get(s)
    if pat is None:
        pat = _Parser(s).parse()
        _PATTERN_CACHE[s] = pat
    return pat


# ---------------------------------------------------------------------------
# match context (per-molecule caches)
# ---------------------------------------------------------------------------

class _MatchCtx:
    def __init__(self, mol: Molecule):
        self.mol = mol
        self._sssr = None
        self._ring_counts = None
        self._ring_sizes = None
        self._valences = None
        self._recursive_cache: Dict[Tuple[int, int], bool] = {}

    def _ensure_rings(self):
        # RDKit's RingInfo (behind the R/r primitives) uses symmetrized SSSR
        if self._ring_counts is None:
            counts = [0] * self.mol.n_atoms
            sizes: List[set] = [set() for _ in range(self.mol.n_atoms)]
            for ring in self.mol.symm_sssr():
                for a in ring:
                    counts[a] += 1
                    sizes[a].add(len(ring))
            self._ring_counts = counts
            self._ring_sizes = sizes

    def ring_count(self, a: int) -> int:
        self._ensure_rings()
        return self._ring_counts[a]

    def ring_sizes(self, a: int):
        self._ensure_rings()
        return self._ring_sizes[a]

    def ring_bond_count(self, a: int) -> int:
        return sum(1 for b in self.mol.atom_bonds(a) if b.in_ring)

    def valence(self, a: int) -> int:
        if self._valences is None:
            self._valences = [
                int(round(self.mol._bond_order_sum(i, kekulized=True)))
                + self.mol.atoms[i].num_hs
                for i in range(self.mol.n_atoms)]
        return self._valences[a]

    def recursive(self, pat: SmartsPattern, a: int) -> bool:
        key = (id(pat), a)
        hit = self._recursive_cache.get(key)
        if hit is None:
            hit = bool(_match(self, pat, root=a, first_only=True))
            self._recursive_cache[key] = hit
        return hit


_CTX_CACHE: Dict[int, Tuple[Molecule, _MatchCtx]] = {}


def _get_ctx(mol: Molecule) -> _MatchCtx:
    ent = _CTX_CACHE.get(id(mol))
    if ent is not None and ent[0] is mol:
        return ent[1]
    ctx = _MatchCtx(mol)
    if len(_CTX_CACHE) > 64:
        _CTX_CACHE.clear()
    _CTX_CACHE[id(mol)] = (mol, ctx)
    return ctx


# ---------------------------------------------------------------------------
# matcher
# ---------------------------------------------------------------------------

def _match(ctx: _MatchCtx, pat: SmartsPattern, root: Optional[int] = None,
           first_only: bool = False) -> List[Tuple[int, ...]]:
    mol = ctx.mol
    n = pat.n_atoms
    if n == 0:
        return []
    # visit order: BFS from pattern atom 0 so each new atom (after the
    # first) is adjacent to an already-mapped one
    order = [0]
    order_bond: List[Optional[Tuple[int, int]]] = [None]
    seen = {0}
    frontier = [0]
    while frontier:
        nxt = []
        for p in frontier:
            for (q, bi) in pat.adj[p]:
                if q not in seen:
                    seen.add(q)
                    order.append(q)
                    order_bond.append((p, bi))
                    nxt.append(q)
        frontier = nxt
    if len(order) != n:
        raise ValueError(f"disconnected SMARTS pattern: {pat.smarts!r}")

    mapping = [-1] * n
    used = [False] * mol.n_atoms
    out: List[Tuple[int, ...]] = []

    def extend(k: int) -> bool:
        if k == n:
            out.append(tuple(mapping))
            return first_only
        p = order[k]
        pexpr = pat.atoms[p]
        if k == 0:
            candidates = [root] if root is not None else range(mol.n_atoms)
            for a in candidates:
                if used[a] or not pexpr.eval(ctx, a):
                    continue
                mapping[p] = a
                used[a] = True
                if extend(k + 1):
                    return True
                used[a] = False
                mapping[p] = -1
            return False
        anchor, bi = order_bond[k]
        ai, aj, bexpr = pat.bonds[bi]
        ma = mapping[anchor]
        for b in mol.atom_bonds(ma):
            cand = b.other(ma)
            if used[cand] or not pexpr.eval(ctx, cand):
                continue
            if not bexpr.eval(ctx, b):
                continue
            # check all other pattern bonds from p to already-mapped atoms
            ok = True
            for (q, bj) in pat.adj[p]:
                if bj == bi or mapping[q] < 0:
                    continue
                mb = mol.bond_between(cand, mapping[q])
                if mb is None or not pat.bonds[bj][2].eval(ctx, mb):
                    ok = False
                    break
            if not ok:
                continue
            mapping[p] = cand
            used[cand] = True
            if extend(k + 1):
                return True
            used[cand] = False
            mapping[p] = -1
        return False

    extend(0)
    return out


def match_all(mol: Molecule, smarts: str,
              uniquify: bool = True) -> List[Tuple[int, ...]]:
    """All substructure matches (RDKit ``GetSubstructMatches`` semantics)."""
    pat = parse_smarts(smarts) if isinstance(smarts, str) else smarts
    matches = _match(_get_ctx(mol), pat)
    if uniquify:
        seen = set()
        uniq = []
        for m in matches:
            key = frozenset(m)
            if key not in seen:
                seen.add(key)
                uniq.append(m)
        return uniq
    return matches


def count_matches(mol: Molecule, smarts: str, uniquify: bool = True) -> int:
    return len(match_all(mol, smarts, uniquify=uniquify))


def has_match(mol: Molecule, smarts: str) -> bool:
    pat = parse_smarts(smarts) if isinstance(smarts, str) else smarts
    return bool(_match(_get_ctx(mol), pat, first_only=True))


def match_rooted(mol: Molecule, smarts, atom: int) -> bool:
    """Does the pattern match with its FIRST atom mapped to ``atom``?

    This is the primitive behind Crippen-style first-match-wins atom
    typing (each table row's pattern is rooted at the typed atom).
    """
    pat = parse_smarts(smarts) if isinstance(smarts, str) else smarts
    return bool(_match(_get_ctx(mol), pat, root=atom, first_only=True))
