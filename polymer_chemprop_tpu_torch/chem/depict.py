"""2D molecule depiction: coordinate layout + SVG rendering (the port's
copy of polymer_chemprop_tpu chem/depict.py).

Fills the visual role the reference outsources to the bundled JSME
molecule-editor assets and RDKit drawing (reference chemprop/web/ static
assets; RDKit's Compute2DCoords behind `rdkit.Chem.Draw`): structure
previews for the web app, interpret rationales, and analysis scripts.
Third-party JS/RDKit cannot be vendored here, so both the layout and the
renderer are original implementations on our own chemistry runtime.

Layout algorithm (standard chemical-drawing conventions):
  1. SSSR rings are grouped into fused systems; each ring is drawn as a
     regular polygon with unit bond length. Fused rings are reflected
     across the shared edge; spiro rings pivot around the shared atom.
  2. Acyclic atoms are placed breadth-first with 120-degree zigzag
     angles (180 for sp centers), picking the least-crowded direction.
  3. Disconnected fragments (e.g. the monomers of a polymer ensemble
     string) are laid out independently and arranged left-to-right.

Rendering: kekulized bond orders (alternating double bonds for aromatic
rings), perpendicular-offset double/triple lines with in-ring doubles
offset toward the ring center, heteroatom labels with implicit-H counts
and charges, wildcard attachment points as ``*:n``, optional atom
highlighting (used by interpret rationales), and wedge/hash stereo
bonds on tetrahedral chiral centers (solid = toward viewer; chosen so
the drawing matches the parity-normalized chiral tag).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple
from xml.sax.saxutils import escape

from .mol import Molecule
from .periodic import NUM_TO_SYMBOL

BOND_LEN = 1.0
_COLLIDE = 0.45  # candidate positions closer than this to a placed atom lose


# --------------------------------------------------------------------- layout

def _ring_systems(rings: List[List[int]]) -> List[List[List[int]]]:
    """Group SSSR rings into connected (atom-sharing) fused systems."""
    systems: List[List[List[int]]] = []
    atom_sets: List[set] = []
    for ring in rings:
        rset = set(ring)
        hits = [i for i, s in enumerate(atom_sets) if s & rset]
        if not hits:
            systems.append([ring])
            atom_sets.append(rset)
        else:
            # merge this ring plus every system it touches into hits[0]
            base = hits[0]
            for i in reversed(hits[1:]):
                systems[base].extend(systems[i])
                atom_sets[base] |= atom_sets[i]
                del systems[i], atom_sets[i]
            systems[base].append(ring)
            atom_sets[base] |= rset
    return systems


def _place_polygon(ring: Sequence[int], anchor: Dict[int, Tuple[float, float]],
                   coords: Dict[int, Tuple[float, float]],
                   away_from: Optional[Tuple[float, float]]) -> None:
    """Place `ring` as a regular polygon.

    `anchor` holds the already-fixed vertices of this ring (0, 1 shared
    atom = spiro, or 2+ = fused edge). Remaining vertices are placed on
    the circle, on the side opposite `away_from` (typically the center
    of the neighbouring, already-drawn ring).
    """
    n = len(ring)
    circum = 0.5 * BOND_LEN / math.sin(math.pi / n)
    placed = [a for a in ring if a in anchor]

    if len(placed) >= 2:
        # find two anchored atoms adjacent in the ring ordering
        pair = None
        for i in range(n):
            u, v = ring[i], ring[(i + 1) % n]
            if u in anchor and v in anchor:
                pair = (u, v)
                break
        if pair is None:
            u = placed[0]
            pair = None
        if pair is not None:
            u, v = pair
            ux, uy = anchor[u]
            vx, vy = anchor[v]
            mx, my = (ux + vx) / 2.0, (uy + vy) / 2.0
            ex, ey = vx - ux, vy - uy
            elen = math.hypot(ex, ey) or 1.0
            # perpendicular to the shared edge
            px, py = -ey / elen, ex / elen
            h = math.sqrt(max(circum * circum - 0.25 * elen * elen, 1e-9))
            c1 = (mx + px * h, my + py * h)
            c2 = (mx - px * h, my - py * h)
            if away_from is None:
                center = c1
            else:
                d1 = math.hypot(c1[0] - away_from[0], c1[1] - away_from[1])
                d2 = math.hypot(c2[0] - away_from[0], c2[1] - away_from[1])
                center = c1 if d1 >= d2 else c2
            # walk the ring from v, rotating u->v's angle by the exterior
            # angle; choose the rotation sign that comes back to u
            start = ring.index(v)
            order = [ring[(start + k) % n] for k in range(n)]
            ang_v = math.atan2(vy - center[1], vx - center[0])
            ang_u = math.atan2(uy - center[1], ux - center[0])
            step = 2.0 * math.pi / n
            # pick the rotation sign so that stepping k times from v lands
            # each order[k] on the circle consistently with where u sits in
            # the walked order (index 1 = next after v, n-1 = previous)
            iu = order.index(u)
            diff = (ang_u - ang_v) % (2.0 * math.pi)
            plus = abs(diff - step) < abs(diff - (2.0 * math.pi - step))
            sign = (1.0 if plus else -1.0) if iu == 1 \
                else (-1.0 if plus else 1.0)
            for k, a in enumerate(order):
                if a in anchor:
                    coords.setdefault(a, anchor[a])
                    continue
                ang = ang_v + sign * step * k
                coords[a] = (center[0] + circum * math.cos(ang),
                             center[1] + circum * math.sin(ang))
            return

    if placed:  # spiro, ring off a chain atom, or a bridged fallback
        u = placed[0]
        ux, uy = anchor[u]
        if away_from is not None:
            dx, dy = ux - away_from[0], uy - away_from[1]
            norm = math.hypot(dx, dy) or 1.0
            dx, dy = dx / norm, dy / norm
        else:
            dx, dy = 1.0, 0.0
        center = (ux + dx * circum, uy + dy * circum)
        start = ring.index(u)
        order = [ring[(start + k) % n] for k in range(n)]
        ang_u = math.atan2(uy - center[1], ux - center[0])
        step = 2.0 * math.pi / n
        for k, a in enumerate(order):
            if a in anchor:
                coords.setdefault(a, anchor[a])
                continue
            ang = ang_u + step * k
            coords[a] = (center[0] + circum * math.cos(ang),
                         center[1] + circum * math.sin(ang))
        return

    # free-standing ring: center at origin-ish (caller shifts fragments)
    center = away_from or (0.0, 0.0)
    for k, a in enumerate(ring):
        ang = math.pi / 2.0 + 2.0 * math.pi * k / n
        coords.setdefault(a, (center[0] + circum * math.cos(ang),
                              center[1] + circum * math.sin(ang)))


def _neighbor_centroid(mol: Molecule, u: int,
                       coords: Dict[int, Tuple[float, float]]
                       ) -> Optional[Tuple[float, float]]:
    pts = [coords[p] for p in mol.neighbors(u) if p in coords]
    if not pts:
        return None
    return (sum(x for x, _ in pts) / len(pts),
            sum(y for _, y in pts) / len(pts))


def _place_ring_system(mol: Molecule, system: List[List[int]],
                       coords: Dict[int, Tuple[float, float]]) -> None:
    """Place all rings of one fused system, most-anchored ring first."""
    todo = sorted(system,
                  key=lambda r: (-sum(1 for a in r if a in coords), -len(r)))
    placed_rings: List[Tuple[List[int], Tuple[float, float]]] = []
    first = todo[0]
    anchor = {a: coords[a] for a in first if a in coords}
    away = None
    if len(anchor) == 1:
        # ring hanging off one placed atom: grow away from that atom's
        # already-placed neighbours (two rings on one atom must diverge)
        away = _neighbor_centroid(mol, next(iter(anchor)), coords)
    _place_polygon(first, anchor, coords, away)
    placed_rings.append((first, _centroid(first, coords)))
    rest = todo[1:]
    while rest:
        # next ring with the most already-placed atoms
        rest.sort(key=lambda r: -sum(1 for a in r if a in coords))
        ring = rest.pop(0)
        anchor = {a: coords[a] for a in ring if a in coords}
        # push away from the neighbouring ring we share the edge with
        neigh = None
        for pring, pcent in placed_rings:
            if len(set(pring) & set(ring)) >= 2:
                neigh = pcent
                break
        if neigh is None and len(anchor) == 1:
            neigh = _neighbor_centroid(mol, next(iter(anchor)), coords)
        if neigh is None and placed_rings:
            neigh = placed_rings[0][1]
        _place_polygon(ring, anchor, coords, neigh)
        placed_rings.append((ring, _centroid(ring, coords)))


def _centroid(atoms: Sequence[int],
              coords: Dict[int, Tuple[float, float]]) -> Tuple[float, float]:
    xs = [coords[a][0] for a in atoms if a in coords]
    ys = [coords[a][1] for a in atoms if a in coords]
    if not xs:
        return (0.0, 0.0)
    return (sum(xs) / len(xs), sum(ys) / len(ys))


def _components(mol: Molecule) -> List[List[int]]:
    seen = set()
    comps = []
    for start in range(mol.n_atoms):
        if start in seen:
            continue
        comp = [start]
        seen.add(start)
        stack = [start]
        while stack:
            a = stack.pop()
            for nb in mol.neighbors(a):
                if nb not in seen:
                    seen.add(nb)
                    comp.append(nb)
                    stack.append(nb)
        comps.append(comp)
    return comps


def compute_2d_coords(mol: Molecule) -> List[Tuple[float, float]]:
    """Unit-bond-length 2D coordinates for every atom (drawing order)."""
    coords: Dict[int, Tuple[float, float]] = {}
    systems = _ring_systems(mol.sssr())
    sys_of_atom: Dict[int, int] = {}
    for si, system in enumerate(systems):
        for ring in system:
            for a in ring:
                sys_of_atom[a] = si
    placed_systems = set()

    x_shift = 0.0
    for comp in _components(mol):
        comp_set = set(comp)
        before = dict(coords)
        # seed: a ring system if the component has one, else the first atom
        seed_sys = next((sys_of_atom[a] for a in comp if a in sys_of_atom),
                        None)
        if seed_sys is not None:
            _place_ring_system(mol, systems[seed_sys], coords)
            placed_systems.add(seed_sys)
        else:
            coords[comp[0]] = (0.0, 0.0)

        # BFS out from whatever is placed
        frontier = [a for a in comp if a in coords]
        zig: Dict[int, float] = {}
        while frontier:
            nxt = []
            for a in frontier:
                for nb in mol.neighbors(a):
                    if nb in coords:
                        continue
                    si = sys_of_atom.get(nb)
                    if si is not None and si not in placed_systems:
                        # entering a new ring system through atom nb:
                        # place nb first as a chain atom, then the system
                        coords[nb] = _chain_position(mol, a, nb, coords, zig)
                        _place_ring_system(mol, systems[si], coords)
                        placed_systems.add(si)
                        nxt.extend(r_at for ring in systems[si]
                                   for r_at in ring if r_at in comp_set)
                        nxt.append(nb)
                    else:
                        coords[nb] = _chain_position(mol, a, nb, coords, zig)
                        nxt.append(nb)
            frontier = nxt

        # shift this fragment to sit right of the previous ones
        new_atoms = [a for a in comp if a not in before]
        if x_shift and new_atoms:
            min_x = min(coords[a][0] for a in new_atoms)
            for a in new_atoms:
                coords[a] = (coords[a][0] - min_x + x_shift, coords[a][1])
        if new_atoms:
            x_shift = max(coords[a][0] for a in new_atoms) + 1.5 * BOND_LEN

    pts = [coords.get(i, (0.0, 0.0)) for i in range(mol.n_atoms)]
    return _relax_collisions(mol, pts)


def _relax_collisions(mol: Molecule, pts: List[Tuple[float, float]],
                      min_sep: float = 0.5, iters: int = 30
                      ) -> List[Tuple[float, float]]:
    """Push coincident/overlapping non-bonded atoms apart.

    Only runs when a collision exists; alternates a repulsion step on
    colliding pairs with a bond-length restoration sweep so the cleanup
    cannot unravel an already-good layout (ring atoms are kept fixed —
    polygons stay exact; only chain atoms move).
    """
    n = len(pts)
    if n < 2:
        return pts
    ring_atom = [a.in_ring for a in mol.atoms]
    bonded = {(min(b.a1, b.a2), max(b.a1, b.a2)) for b in mol.bonds}
    pts = [list(p) for p in pts]
    for _ in range(iters):
        moved = False
        for i in range(n):
            for j in range(i + 1, n):
                if (i, j) in bonded:
                    continue
                dx = pts[j][0] - pts[i][0]
                dy = pts[j][1] - pts[i][1]
                d = math.hypot(dx, dy)
                if d >= min_sep * 0.999:
                    continue
                if d < 1e-6:
                    # coincident: separate along a deterministic direction
                    dx, dy, d = 1.0, 0.5, math.hypot(1.0, 0.5)
                push = 0.5 * (min_sep - d)
                ux, uy = dx / d, dy / d
                wi = 0.0 if ring_atom[i] else 1.0
                wj = 0.0 if ring_atom[j] else 1.0
                if wi == 0.0 and wj == 0.0:
                    continue
                tot = wi + wj
                pts[i][0] -= ux * push * 2.0 * wi / tot
                pts[i][1] -= uy * push * 2.0 * wi / tot
                pts[j][0] += ux * push * 2.0 * wj / tot
                pts[j][1] += uy * push * 2.0 * wj / tot
                moved = True
        if not moved:
            break
        # restore bond lengths (chain atoms only)
        for b in mol.bonds:
            i, j = b.a1, b.a2
            dx = pts[j][0] - pts[i][0]
            dy = pts[j][1] - pts[i][1]
            d = math.hypot(dx, dy) or 1.0
            err = d - BOND_LEN
            if abs(err) < 0.05:
                continue
            ux, uy = dx / d, dy / d
            wi = 0.0 if ring_atom[i] else 1.0
            wj = 0.0 if ring_atom[j] else 1.0
            if wi == 0.0 and wj == 0.0:
                continue
            tot = wi + wj
            pts[i][0] += ux * err * wi / tot
            pts[i][1] += uy * err * wi / tot
            pts[j][0] -= ux * err * wj / tot
            pts[j][1] -= uy * err * wj / tot
    return [tuple(p) for p in pts]


def _chain_position(mol: Molecule, a: int, nb: int,
                    coords: Dict[int, Tuple[float, float]],
                    zig: Dict[int, float]) -> Tuple[float, float]:
    """Pick a position for unplaced neighbour `nb` of placed atom `a`."""
    ax, ay = coords[a]
    placed_nbrs = [p for p in mol.neighbors(a) if p in coords]
    bond = mol.bond_between(a, nb)
    linear = (bond is not None and bond.order == 3) or \
        mol.atoms[a].hybridization == "SP"

    if not placed_nbrs:
        cands = [0.0, math.pi / 3.0, -math.pi / 3.0, math.pi]
    elif linear and len(placed_nbrs) >= 1:
        px, py = coords[placed_nbrs[0]]
        base = math.atan2(ay - py, ax - px)
        cands = [base]
    elif len(placed_nbrs) == 1:
        px, py = coords[placed_nbrs[0]]
        base = math.atan2(ay - py, ax - px)
        flip = zig.get(a, 1.0)
        cands = [base + flip * math.pi / 3.0, base - flip * math.pi / 3.0,
                 base, base + flip * 2.0 * math.pi / 3.0]
        zig[a] = -flip
    else:
        # bisect the widest angular gap around a
        angs = sorted(math.atan2(coords[p][1] - ay, coords[p][0] - ax)
                      for p in placed_nbrs)
        gaps = [(angs[(i + 1) % len(angs)] - angs[i]) % (2.0 * math.pi) or
                2.0 * math.pi for i in range(len(angs))]
        i = max(range(len(gaps)), key=gaps.__getitem__)
        cands = [angs[i] + gaps[i] / 2.0]
        # fallbacks slightly rotated
        cands += [cands[0] + 0.3, cands[0] - 0.3]

    best, best_score = None, -1e9
    occupied = list(coords.values())
    for ang in cands:
        x = ax + BOND_LEN * math.cos(ang)
        y = ay + BOND_LEN * math.sin(ang)
        dmin = min((math.hypot(x - ox, y - oy) for ox, oy in occupied
                    if (ox, oy) != (ax, ay)), default=10.0)
        score = min(dmin, 2.0)
        if dmin < _COLLIDE:
            score -= 10.0
        if score > best_score:
            best, best_score = (x, y), score
    return best  # type: ignore[return-value]


def _det3(a, b, c) -> float:
    return (a[0] * (b[1] * c[2] - b[2] * c[1])
            - a[1] * (b[0] * c[2] - b[2] * c[0])
            + a[2] * (b[0] * c[1] - b[1] * c[0]))


def _wedge_assignments(mol: Molecule,
                       pts: List[Tuple[float, float]]):
    """Choose wedge/hash bonds for tetrahedral chiral centers.

    chiral tags are parity-normalized to the molecule bond-list
    neighbour order with implicit/bracket H LAST (chem/smiles.py
    _normalize_chirality). By the SMILES definition ('@' = neighbours
    2,3,4 counterclockwise viewed from neighbour 1),
    '@' == CHI_TETRAHEDRAL_CCW  <=>  det[p2-p1, p3-p1, p4-p1] < 0.
    One drawn single bond per center is rendered solid (toward viewer)
    or hashed (away) so the drawing's determinant matches the tag.

    Returns {bond_idx: (center_atom, solid)}.
    """
    from .mol import CHI_TETRAHEDRAL_CCW, CHI_TETRAHEDRAL_CW, SINGLE
    out = {}
    for atom in mol.atoms:
        if atom.chiral_tag not in (CHI_TETRAHEDRAL_CW, CHI_TETRAHEDRAL_CCW):
            continue
        a = atom.idx
        bonds = mol.atom_bonds(a)
        heavy = [b.other(a) for b in bonds]
        if len(heavy) + (1 if atom.num_hs else 0) != 4 or len(heavy) < 3:
            continue
        # wedge target: prefer acyclic single bonds to terminal atoms
        def pref(b):
            o = b.other(a)
            return (b.order != SINGLE, b.in_ring, mol.degree(o) > 1,
                    b.idx in out)
        cand = [b for b in bonds if b.order == SINGLE]
        if not cand:
            continue
        wb = min(cand, key=pref)
        w_atom = wb.other(a)
        cx, cy = pts[a]
        # neighbour positions in tag order (implicit H virtual, LAST)
        order3 = []
        for nb in heavy:
            order3.append((pts[nb][0] - cx, pts[nb][1] - cy, 0.0))
        if atom.num_hs and len(heavy) == 3:
            sx = sum(v[0] for v in order3)
            sy = sum(v[1] for v in order3)
            n = math.hypot(sx, sy)
            hxy = (-sx / n, -sy / n) if n > 1e-6 else (0.3, 0.1)
            order3.append((hxy[0], hxy[1], 0.0))
        # tentative: wedge target toward the viewer (+z)
        wi = heavy.index(w_atom)
        order3[wi] = (order3[wi][0], order3[wi][1], 1.0)
        d = _det3(*(tuple(x - y for x, y in zip(order3[k], order3[0]))
                    for k in (1, 2, 3)))
        want_neg = atom.chiral_tag == CHI_TETRAHEDRAL_CCW
        solid = (d < 0) == want_neg
        out[wb.idx] = (a, solid)
    return out


# ------------------------------------------------------------------ rendering

def _atom_label(mol: Molecule, i: int) -> Optional[str]:
    a = mol.atoms[i]
    if a.is_wildcard():
        n = a.props.get("atom_map")
        return f"*:{n}" if n else "*"
    sym = NUM_TO_SYMBOL.get(a.atomic_num, "?")
    if a.atomic_num == 6 and a.formal_charge == 0 and a.isotope == 0 \
            and mol.degree(i) > 0:
        return None  # skeletal carbon
    label = sym
    if a.isotope:
        label = f"{a.isotope}{sym}"
    if a.num_hs == 1:
        label += "H"
    elif a.num_hs > 1:
        label += f"H{a.num_hs}"
    if a.formal_charge == 1:
        label += "+"
    elif a.formal_charge == -1:
        label += "-"
    elif a.formal_charge:
        label += f"{a.formal_charge:+d}"
    return label


_HETERO_COLOR = {7: "#2B6CB8", 8: "#C5362C", 16: "#B58A00", 9: "#3E9C35",
                 17: "#3E9C35", 35: "#8A4B26", 53: "#6B3FA0", 15: "#C96F1A"}


def depict_svg(mol: Molecule, width: int = 320, height: int = 240,
               highlight_atoms: Optional[Sequence[int]] = None) -> str:
    """Render the molecule as a standalone SVG document string."""
    n = mol.n_atoms
    if n == 0:
        return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
                f'height="{height}"/>')
    pts = compute_2d_coords(mol)
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    margin = 18.0
    span_x = max(xs) - min(xs) or 1.0
    span_y = max(ys) - min(ys) or 1.0
    scale = min((width - 2 * margin) / span_x,
                (height - 2 * margin) / span_y, 42.0)
    ox = (width - scale * span_x) / 2.0 - scale * min(xs)
    oy = (height - scale * span_y) / 2.0 - scale * min(ys)

    def sxy(i: int) -> Tuple[float, float]:
        # flip y: chemistry up = SVG down
        return (ox + scale * pts[i][0],
                height - (oy + scale * pts[i][1]))

    labels = {i: _atom_label(mol, i) for i in range(n)}
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}" viewBox="0 0 {width} {height}">',
             '<rect width="100%" height="100%" fill="white"/>']

    if highlight_atoms:
        for i in highlight_atoms:
            if 0 <= i < n:
                x, y = sxy(i)
                parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" '
                             f'r="{0.38 * scale:.1f}" fill="#FFD7A1"/>')

    ring_centers = [(set(r), _centroid(r, dict(enumerate(pts))))
                    for r in mol.sssr()]
    wedges = _wedge_assignments(mol, pts)

    def shrink(x1, y1, x2, y2, frac1, frac2):
        dx, dy = x2 - x1, y2 - y1
        return (x1 + dx * frac1, y1 + dy * frac1,
                x2 - dx * frac2, y2 - dy * frac2)

    for b in mol.bonds:
        x1, y1 = sxy(b.a1)
        x2, y2 = sxy(b.a2)
        f1 = 0.18 if labels[b.a1] else 0.0
        f2 = 0.18 if labels[b.a2] else 0.0
        X1, Y1, X2, Y2 = shrink(x1, y1, x2, y2, f1, f2)
        order = b.kekule_order if b.is_aromatic else b.order
        dx, dy = x2 - x1, y2 - y1
        blen = math.hypot(dx, dy) or 1.0
        px, py = -dy / blen, dx / blen  # unit perpendicular
        off = 0.10 * scale
        line = (lambda a1, b1, a2, b2:
                f'<line x1="{a1:.1f}" y1="{b1:.1f}" x2="{a2:.1f}" '
                f'y2="{b2:.1f}" stroke="black" stroke-width="1.6"/>')
        if b.idx in wedges and order == 1:
            # stereo bond: narrow end at the chiral center
            center_atom, solid = wedges[b.idx]
            if center_atom == b.a2:
                X1, Y1, X2, Y2 = X2, Y2, X1, Y1
            hw = 0.14 * scale  # half-width of the broad end
            if solid:
                parts.append(
                    f'<polygon points="{X1:.1f},{Y1:.1f} '
                    f'{X2 + px * hw:.1f},{Y2 + py * hw:.1f} '
                    f'{X2 - px * hw:.1f},{Y2 - py * hw:.1f}" '
                    f'fill="black"/>')
            else:
                for k in range(6):
                    t = (k + 1) / 6.0
                    hx = X1 + (X2 - X1) * t
                    hy = Y1 + (Y2 - Y1) * t
                    parts.append(
                        f'<line x1="{hx + px * hw * t:.1f}" '
                        f'y1="{hy + py * hw * t:.1f}" '
                        f'x2="{hx - px * hw * t:.1f}" '
                        f'y2="{hy - py * hw * t:.1f}" '
                        f'stroke="black" stroke-width="1.4"/>')
        elif order == 2:
            if b.in_ring:
                # main line on the bond, second line toward ring center
                for rset, cent in ring_centers:
                    if b.a1 in rset and b.a2 in rset:
                        cxs, cys = cent
                        cx = ox + scale * cxs
                        cy = height - (oy + scale * cys)
                        s = 1.0 if (px * (cx - x1) + py * (cy - y1)) > 0 \
                            else -1.0
                        break
                else:
                    s = 1.0
                parts.append(line(X1, Y1, X2, Y2))
                ix1, iy1, ix2, iy2 = shrink(x1 + s * px * off * 1.7,
                                            y1 + s * py * off * 1.7,
                                            x2 + s * px * off * 1.7,
                                            y2 + s * py * off * 1.7,
                                            max(f1, 0.18), max(f2, 0.18))
                parts.append(line(ix1, iy1, ix2, iy2))
            else:
                parts.append(line(X1 + px * off, Y1 + py * off,
                                  X2 + px * off, Y2 + py * off))
                parts.append(line(X1 - px * off, Y1 - py * off,
                                  X2 - px * off, Y2 - py * off))
        elif order == 3:
            parts.append(line(X1, Y1, X2, Y2))
            parts.append(line(X1 + px * off * 1.8, Y1 + py * off * 1.8,
                              X2 + px * off * 1.8, Y2 + py * off * 1.8))
            parts.append(line(X1 - px * off * 1.8, Y1 - py * off * 1.8,
                              X2 - px * off * 1.8, Y2 - py * off * 1.8))
        else:
            parts.append(line(X1, Y1, X2, Y2))

    fs = max(9.0, 0.42 * scale)
    for i, label in labels.items():
        if not label:
            continue
        x, y = sxy(i)
        color = _HETERO_COLOR.get(mol.atoms[i].atomic_num, "black")
        parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" '
                     f'r="{fs * 0.85:.1f}" fill="white"/>')
        parts.append(f'<text x="{x:.1f}" y="{y + fs * 0.35:.1f}" '
                     f'font-family="Helvetica,Arial,sans-serif" '
                     f'font-size="{fs:.1f}" text-anchor="middle" '
                     f'fill="{color}">{escape(label)}</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def depict_smiles_svg(smiles: str, width: int = 320, height: int = 240,
                      highlight_atoms: Optional[Sequence[int]] = None
                      ) -> Optional[str]:
    """Parse (the molecule part of) a SMILES / ensemble string and render.

    Polymer ensemble strings (``smiles|weights|<rules``) are depicted as
    their monomer fragments side by side. Returns None if unparseable.
    """
    from .smiles import parse_smiles
    mol = parse_smiles(smiles.split("|")[0], strict=False)
    if mol is None:
        return None
    # the collision-relaxation layout is O(n^2) per iteration; refuse
    # pathological inputs rather than stalling the (single-threaded) caller
    if mol.n_atoms > 300:
        return None
    return depict_svg(mol, width=width, height=height,
                      highlight_atoms=highlight_atoms)
