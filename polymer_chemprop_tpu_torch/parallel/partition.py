"""Edge-partitioned message passing: one batched graph over the ranks of a
mesh axis.

The port's counterpart of polymer_chemprop_tpu parallel/partition.py, the
graph analogue of sequence parallelism: the bond axis is split into
chunks of (fwd, rev) pairs, one per rank of the ``ep`` axis, and the
parameters are replicated. The host partitioners are copies of the JAX
package's (numpy only). The reverse-bond gather is always shard-local, so
the only cross-rank dependency of a layer is the atom aggregation:

* ``make_edge_parallel_forward``: each rank sums its bonds into the whole
  atom axis and the partials are all-reduced (:class:`_AllReduceFn`);
* the halo forms (``build_edge_shards_halo``): each shard owns a window of
  ``Aw`` atoms, and a layer exchanges the window partials with the two ep
  neighbours (:class:`_HaloCombineFn`), or only the two boundary strips,
  posted before the interior aggregation and waited for after it
  (:class:`_HaloCombineOverlapFn`), row-exact against the whole-window
  exchange.

Inside every shard the aggregation runs on row 3's kernel
(``ops/band_mpnn.py`` ``atom_readout``, csrc/atom_readout.cu) over a
shard-local dst-sorted CSR (``ops/sorted_aux.py``) against the shard's atom
window: window slot 0 is the padding sink, so local atom ids shift by +1
and the table has ``Aw + 1`` rows. That is the JAX package's ``halo_band``
design; here it serves every halo form, since the CUDA kernels read a CSR
at any size (no Mosaic tiles). A layer is then

    partial = atom_readout(m)           (row 3; (Aw + 1, H))
    a_win   = combine(partial[1:])      (the halo exchange)
    z       = [0; a_win][src] - m[srev]
    m       = act(inputs + W_h z)

The fused layer (row 1, ``band_rev_layer``) cannot serve here: the
exchange has to sit between the aggregation and the reverse subtraction,
inside what that kernel does in one pass. The VJP of the gather
``a[src]`` is the sum over the bonds that leave each atom,
``da[u] = sum_{c in run(u)} dz[srev c]``: row 3's gather entry
(``csr_gather_sum``) with index ``srev`` and unit weights, never an
``index_add_``. ``atom_messages`` runs its neighbour sum and readout on
that entry too (``atom_neighbor_sum_sorted``, ``src_readout_sorted``), and
the molecule readout of the owned atoms is the single-device encoder's,
the weighted gather entry over a per-shard molecule CSR
(``ops/band_mpnn.py`` ``molecule_sum``, ``ops/sorted_aux.py``
``build_molecule_csr`` over the owned rows). So on a card the
edge-partitioned encoder runs no ``index_add_``; on the CPU every kernel
op runs its plain version.

Collectives carry gradients: a halo combine's backward sends the
cotangent rows back by the same offsets, and the all-reduce's backward
all-reduces the cotangent. The molecule readout is all-reduced over the ep
ranks, after which every ep rank computes the same FFN and loss; the train
steps divide each rank's loss by ``n_ep`` and sum every parameter gradient
over all ranks in one flat all-reduce, which counts that replicated part
once.

Each function takes the same stacked host arrays on every rank (leading
``(n_shards, ...)``, or ``(n_dp, n_ep, ...)`` for the 2-D step) and uses
its own shard; tensors go to the device of the model's parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.nn import dense, get_activation, linear
from ..ops import band_mpnn as bm
from ..ops.sorted_aux import build_molecule_csr, build_sorted_aux
from .mesh import Mesh, all_reduce_sum, exchange


# ---------------------------------------------------------------------------
# host partitioners (copies of the JAX package's)
# ---------------------------------------------------------------------------

def _pair_chunks(B: int, n_shards: int):
    """(pairs_per_shard, Bs, [(lo, hi)] of each shard's global bonds)."""
    n_pairs = (B - 1) // 2
    pairs_per_shard = -(-n_pairs // n_shards)
    Bs = pairs_per_shard * 2 + 1   # +1: every shard gets its own zero slot 0
    spans = [(1 + s * pairs_per_shard * 2,
              min(1 + (s + 1) * pairs_per_shard * 2, B))
             for s in range(n_shards)]
    return pairs_per_shard, Bs, spans


def _shard_bond_array(x: np.ndarray, Bs: int, spans) -> np.ndarray:
    out = np.zeros((len(spans), Bs) + x.shape[1:], dtype=x.dtype)
    for s, (lo, hi) in enumerate(spans):
        if hi > lo:
            out[s, 1:1 + hi - lo] = x[lo:hi]
    return out


def _local_rev(n_shards: int, Bs: int) -> np.ndarray:
    """Shard-local reverse index: the global pairs (2k+1, 2k+2) land on
    local (2j+1, 2j+2)."""
    rev = np.zeros((n_shards, Bs), np.int32)
    idx = np.arange(1, Bs, dtype=np.int32)
    rev[:, 1:] = np.clip(np.where(idx % 2 == 1, idx + 1, idx - 1), 0, Bs - 1)
    return rev


def build_edge_shards(arrays: Dict[str, np.ndarray], n_shards: int
                      ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Split the bond axis into pair-aligned per-shard arrays (JAX
    partition.py:41-83). Returns ``(sharded, replicated)``: ``sharded``
    leaves have a leading ``(n_shards, ...)`` axis and local reverse
    indices; ``replicated`` carries the atom and molecule arrays."""
    _, Bs, spans = _pair_chunks(arrays["f_bonds"].shape[0], n_shards)
    sharded = {k: _shard_bond_array(arrays[k], Bs, spans)
               for k in ("f_bonds", "w_bonds", "b2a", "b2dst")}
    sharded["b2revb_local"] = _local_rev(n_shards, Bs)
    replicated = {k: arrays[k] for k in
                  ("f_atoms", "w_atoms", "a2mol", "degree_of_polym",
                   "mol_mask")}
    return sharded, replicated


def build_edge_shards_halo(arrays: Dict[str, np.ndarray], n_shards: int,
                           atom_window: int = None,
                           atom_descriptors: np.ndarray = None
                           ) -> Tuple[Dict[str, np.ndarray],
                                      Dict[str, np.ndarray]]:
    """Host partitioner of the halo forms (JAX partition.py:126-290).

    A contiguous chunk of bond pairs references one contiguous atom window
    (atoms are numbered per molecule); each shard gets a window of width
    ``Aw`` (the widest, or ``atom_window`` when given), adjacent windows
    overlapping only at the molecule cut by the boundary. Raises
    ValueError when a molecule spans 3+ shards, or when the derived window
    exceeds ``atom_window``. Besides the JAX package's fields each shard
    carries ``num_atoms``, the batch's atom count, for the row-keyed window
    dropout masks."""
    B = arrays["f_bonds"].shape[0]
    A = arrays["f_atoms"].shape[0]
    _, Bs, spans = _pair_chunks(B, n_shards)
    b2a, b2dst = arrays["b2a"], arrays["b2dst"]

    # per-shard referenced atom windows
    o = np.zeros(n_shards, np.int64)
    hi_atom = np.zeros(n_shards, np.int64)
    for s, (lo, hi) in enumerate(spans):
        real = np.zeros(0, np.int64)
        if hi > lo:
            ref = np.concatenate([b2a[lo:hi], b2dst[lo:hi]])
            real = ref[ref > 0]
        if real.size == 0:
            # empty tail shard: window past the end (owns nothing; keeps o
            # monotone for searchsorted)
            o[s] = hi_atom[s] = A
        else:
            o[s], hi_atom[s] = real.min(), real.max() + 1
    for s in range(n_shards - 2):
        if hi_atom[s] > o[s + 2]:
            raise ValueError(
                "a molecule spans 3+ edge shards; use build_edge_shards "
                "(psum variant) instead")
    # extend windows over the gaps between them: atoms with no incoming
    # bonds (single-atom molecules) still reach the readout through W_o
    nz = np.nonzero(arrays["w_atoms"] > 0)[0]
    real_hi = int(nz.max()) + 1 if nz.size else 1
    first_real = int(nz.min()) if nz.size else 1
    if n_shards > 0 and o[0] > first_real:
        o[0] = first_real
    for s in range(n_shards - 1):
        if o[s] < A:
            hi_atom[s] = max(hi_atom[s], min(int(o[s + 1]), real_hi))
    for s in range(n_shards - 1, -1, -1):
        if o[s] < A:
            hi_atom[s] = max(hi_atom[s], real_hi)
            break
    Aw = int(((hi_atom - o).max() + 7) // 8 * 8)
    if atom_window is not None:
        if Aw > atom_window:
            raise ValueError(
                f"derived halo window {Aw} exceeds the fixed atom_window "
                f"{atom_window}; enlarge the envelope or fall back")
        Aw = int(atom_window)

    sharded = {"f_bonds": _shard_bond_array(arrays["f_bonds"], Bs, spans),
               "w_bonds": _shard_bond_array(arrays["w_bonds"], Bs, spans)}
    b2a_s = _shard_bond_array(b2a, Bs, spans)
    b2dst_s = _shard_bond_array(b2dst, Bs, spans)
    loc = lambda x: np.clip(x - o[:, None], 0, Aw - 1).astype(np.int32)
    sharded["b2a_local"] = loc(b2a_s)
    sharded["b2dst_local"] = loc(b2dst_s)
    sharded["bond_mask"] = (b2dst_s > 0).astype(np.float32)
    sharded["b2revb_local"] = _local_rev(n_shards, Bs)

    F = arrays["f_atoms"].shape[1]
    f_win = np.zeros((n_shards, Aw, F), arrays["f_atoms"].dtype)
    w_win = np.zeros((n_shards, Aw), arrays["w_atoms"].dtype)
    mol_win = np.zeros((n_shards, Aw), np.int32)
    own = np.zeros((n_shards, Aw), np.float32)
    for s in range(n_shards):
        lo, hi = int(o[s]), min(int(o[s]) + Aw, A)
        f_win[s, :hi - lo] = arrays["f_atoms"][lo:hi]
        w_win[s, :hi - lo] = arrays["w_atoms"][lo:hi]
        mol_win[s, :hi - lo] = arrays["a2mol"][lo:hi]
    # ownership partitions the real atoms [1, A): the owner of atom a is
    # the last shard whose window starts at or before a
    atoms = np.arange(1, A)
    owner = np.searchsorted(o, atoms, side="right") - 1
    r = atoms - o[owner]
    valid = r < Aw
    own[owner[valid], r[valid]] = 1.0
    sharded["f_atoms_win"] = f_win
    sharded["w_atoms_win"] = w_win
    sharded["a2mol_win"] = mol_win
    sharded["own_mask"] = own
    # global atom index of window row 0 (row-keyed window dropout)
    sharded["win_start"] = o.astype(np.int32)
    sharded["num_atoms"] = np.full(n_shards, A, np.int32)
    # shift offsets, clipped so a missing neighbour lands in the zero half
    sharded["off_prev"] = np.clip(np.array(
        [0] + [int(o[s] - o[s - 1]) for s in range(1, n_shards)], np.int64),
        0, Aw).astype(np.int32)
    sharded["off_next"] = np.clip(np.array(
        [int(Aw + o[s] - o[s + 1]) for s in range(n_shards - 1)] + [Aw],
        np.int64), 0, Aw).astype(np.int32)

    if atom_descriptors is not None:
        D = atom_descriptors.shape[1]
        d_win = np.zeros((n_shards, Aw, D), atom_descriptors.dtype)
        for s in range(n_shards):
            lo, hi = int(o[s]), min(int(o[s]) + Aw, A)
            d_win[s, :hi - lo] = atom_descriptors[lo:hi]
        sharded["atom_desc_win"] = d_win

    # real window extents for the strip exchange: rows >= ext are padding
    ext = np.clip(hi_atom - o, 0, Aw).astype(np.int32)
    sharded["ext"] = ext
    sharded["ext_prev"] = np.concatenate([[0], ext[:-1]]).astype(np.int32)
    sharded["ext_next"] = np.concatenate([ext[1:], [0]]).astype(np.int32)

    replicated = {k: arrays[k] for k in ("degree_of_polym", "mol_mask")}
    return sharded, replicated


_CSR_KEYS = ("f_bonds_sorted", "srev", "src_sorted", "dst_sorted",
             "w_sorted", "rowptr")


def shard_csr(sh: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One halo shard's dst-sorted CSR against its atom window (no leading
    axis): window slot 0 is the padding sink, so real bonds' local atom
    ids shift by +1 and the CSR has ``Aw + 1`` atoms; padding bonds sort
    last and lie in no run. Adds :data:`_CSR_KEYS` to a copy of ``sh``;
    a shard that has them (``build_edge_shards_halo_band``) is returned as
    it is."""
    if "rowptr" in sh:
        return sh
    Aw = sh["f_atoms_win"].shape[0]
    dst = np.where(sh["bond_mask"] > 0, sh["b2dst_local"] + 1, 0)
    aux = build_sorted_aux(dst.astype(np.int32), sh["b2revb_local"],
                           sh["w_bonds"], num_atoms=Aw + 1)
    out = dict(sh)
    out["f_bonds_sorted"] = sh["f_bonds"][aux.perm]
    for k in _CSR_KEYS[1:]:
        out[k] = getattr(aux, k)
    return out


def build_edge_shards_halo_band(arrays: Dict[str, np.ndarray],
                                n_shards: int,
                                atom_window: int = None
                                ) -> Tuple[Dict[str, np.ndarray],
                                           Dict[str, np.ndarray]]:
    """Halo shards with each shard's CSR built ahead (:func:`shard_csr`,
    stacked): the counterpart of JAX partition.py:415-475, on
    ops/sorted_aux.py with no tile padding. Every halo forward takes
    either layout."""
    sharded, replicated = build_edge_shards_halo(arrays, n_shards,
                                                 atom_window)
    shards = [shard_csr({k: v[s] for k, v in sharded.items()})
              for s in range(n_shards)]
    return ({k: np.stack([s[k] for s in shards]) for k in shards[0]},
            replicated)


def halo_strip_width(sharded: Dict[str, np.ndarray]) -> int:
    """Strip width of the overlapped exchange: the widest window overlap
    across shards, a multiple of 8 (JAX partition.py:560-575)."""
    Aw = int(sharded["f_atoms_win"].shape[-2])
    off_prev = np.asarray(sharded["off_prev"]).reshape(-1)
    off_next = np.asarray(sharded["off_next"]).reshape(-1)
    ext = np.asarray(sharded["ext"]).reshape(-1)
    ext_prev = np.asarray(sharded["ext_prev"]).reshape(-1)
    w_prev = int(np.maximum(ext_prev - off_prev, 0).max()) if ext.size else 0
    w_next = int(np.maximum(ext - (Aw - off_next), 0).max()) if ext.size else 0
    sw = max(w_prev, w_next, 1)
    sw = min((sw + 7) // 8 * 8, Aw)
    return max(sw, 8)


def build_edge_shards_halo_dp(arrays_list, n_ep: int, atom_window: int,
                              atom_descriptors_list=None):
    """Partition one batch per dp replica and stack along a leading dp
    axis (JAX partition.py:685-717): sharded leaves become
    ``(n_dp, n_ep, ...)``, replicated ``(n_dp, ...)``. With several
    molecules a datapoint, each replica's entry is a list of per-position
    array dicts and the result a tuple of per-position stacks."""
    multi = isinstance(arrays_list[0], (list, tuple))
    if not multi:
        arrays_list = [[a] for a in arrays_list]
    out_sh, out_rep = [], []
    for pos in range(len(arrays_list[0])):
        shs, reps = [], []
        for d, arrays in enumerate(arrays_list):
            ad = (atom_descriptors_list[d]
                  if atom_descriptors_list is not None and pos == 0
                  else None)
            sh, rep = build_edge_shards_halo(arrays[pos], n_ep,
                                             atom_window=atom_window,
                                             atom_descriptors=ad)
            shs.append(sh)
            reps.append(rep)
        out_sh.append({k: np.stack([s[k] for s in shs]) for k in shs[0]})
        out_rep.append({k: np.stack([r[k] for r in reps])
                        for k in reps[0]})
    if not multi:
        return out_sh[0], out_rep[0]
    return tuple(out_sh), tuple(out_rep)


# ---------------------------------------------------------------------------
# collectives with gradients
# ---------------------------------------------------------------------------

class _AllReduceFn(torch.autograd.Function):
    """Sum over a process group; the backward sums the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceFn.apply(x, group)


def _zeros(x, n):
    return x.new_zeros((n,) + tuple(x.shape[1:]))


def _shift_prev(x, off):
    """``y[i] = x[i + off]``, 0 past the end."""
    return x if off == 0 else torch.cat([x[off:], _zeros(x, off)])


def _unshift_prev(g, off):
    """Transpose of :func:`_shift_prev`: ``t[j] = g[j - off]``."""
    return g if off == 0 else torch.cat([_zeros(g, off),
                                         g[:g.shape[0] - off]])


def _shift_next(x, off):
    """``y[i] = x[i + off - Aw]``, 0 before the start."""
    Aw = x.shape[0]
    return torch.cat([_zeros(x, Aw - off), x[:off]])


def _unshift_next(g, off):
    """Transpose of :func:`_shift_next`: ``t[j] = g[j + Aw - off]``."""
    Aw = g.shape[0]
    return torch.cat([g[Aw - off:], _zeros(g, Aw - off)])


class _HaloCombineFn(torch.autograd.Function):
    """Own window partial plus the two neighbours' partials shifted into
    this window (JAX partition.py:293-311); a missing neighbour delivers
    zeros. The backward is the transposed exchange."""

    @staticmethod
    def forward(ctx, partial, mesh, axis, off_prev, off_next):
        ctx.args = (mesh, axis, off_prev, off_next)
        fp, fn = exchange(mesh, axis, partial, partial).wait()
        return partial + _shift_prev(fp, off_prev) + _shift_next(fn, off_next)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, off_prev, off_next = ctx.args
        fp, fn = exchange(mesh, axis, _unshift_prev(g, off_prev),
                          _unshift_next(g, off_next)).wait()
        return g + fp + fn, None, None, None, None


class _HaloCombineOverlapFn(torch.autograd.Function):
    """The strip form (JAX partition.py:578-608): only the two boundary
    strips of ``sw`` rows travel. The exchange was posted (``pending``)
    before the interior aggregation ran; this waits for it and adds the
    strips at their rows: the neighbour's end strip at ``place`` (anchored
    at its real extent), its begin strip at row 0. ``start`` is where this
    rank's own end strip was cut."""

    @staticmethod
    def forward(ctx, interior, strip, pending, mesh, axis, off_prev,
                off_next, sw, start, place):
        ctx.args = (mesh, axis, off_prev, off_next, sw, start, place)
        fps, fns = pending.wait()
        from_prev = torch.zeros_like(strip)
        from_prev[place:place + sw] = fps
        from_next = torch.zeros_like(strip)
        from_next[:sw] = fns
        return (interior + strip + _shift_prev(from_prev, off_prev)
                + _shift_next(from_next, off_next))

    @staticmethod
    def backward(ctx, g):
        mesh, axis, off_prev, off_next, sw, start, place = ctx.args
        fp, fn = exchange(
            mesh, axis, _unshift_prev(g, off_prev)[place:place + sw],
            _unshift_next(g, off_next)[:sw]).wait()
        d_strip = g.clone()
        d_strip[:sw] += fp
        d_strip[start:start + sw] += fn
        return (g, d_strip) + (None,) * 8


class _SrcGatherFn(torch.autograd.Function):
    """``a[src]`` over dst-sorted bonds, ``(A, H) -> (B, H)``. The VJP is
    the sum over the bonds that leave each atom, ``da[u] = sum_{c in
    run(u)} g[srev c]``, on row 3's gather entry with unit weights. Row 0
    (the padding atom, read only by padding bonds, which lie in no run)
    gets no gradient: callers hold it at zero."""

    @staticmethod
    def forward(ctx, a, src_sorted, srev, rowptr):
        ctx.save_for_backward(srev, rowptr)
        return a.index_select(0, src_sorted.long())

    @staticmethod
    def backward(ctx, g):
        srev, rowptr = ctx.saved_tensors
        return (bm.csr_gather_sum(g, srev, None, rowptr),
                None, None, None)


# ---------------------------------------------------------------------------
# per-rank preparation
# ---------------------------------------------------------------------------

_INT32_KEYS = ("src_sorted", "srev", "rowptr", "mol_idx", "mol_rowptr")
_SCALAR_KEYS = ("off_prev", "off_next", "ext", "ext_prev", "ext_next",
                "win_start", "num_atoms")


def _tensors(d: Dict, device) -> Dict:
    out = {}
    for k, v in d.items():
        if k in _SCALAR_KEYS:
            out[k] = int(np.asarray(v).reshape(()))
            continue
        v = np.asarray(v)
        if v.dtype.kind == "f":
            out[k] = torch.as_tensor(v, dtype=torch.float32, device=device)
        else:
            dtype = torch.int32 if k in _INT32_KEYS else torch.int64
            out[k] = torch.as_tensor(v, dtype=dtype,
                                     device=device).contiguous()
    return out


def _prepare_halo(sh: Dict, rep: Dict, device) -> Dict:
    """One rank's halo shard on ``device``: its CSR (:func:`shard_csr`),
    the molecule CSR of the atoms it owns, ints as Python ints."""
    sh = shard_csr(sh)
    own_w = sh["w_atoms_win"] * sh["own_mask"]
    d = {k: v for k, v in sh.items()
         if k not in ("f_bonds", "b2a_local", "b2dst_local",
                      "b2revb_local", "bond_mask")}
    d.update(build_molecule_csr(sh["a2mol_win"], own_w,
                                rep["degree_of_polym"].shape[0],
                                rows=np.nonzero(own_w != 0)[0]))
    d["own_w"] = own_w.astype(np.float32)
    d["degree_of_polym"] = rep["degree_of_polym"]
    return _tensors(d, device)


def _take(tree, index):
    """The entry at ``index`` of every leaf's leading axes."""
    return {k: np.asarray(v)[index] for k, v in tree.items()}


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


class _WindowDropout:
    """Dropout of one shard's encoder (JAX partition.py:757-791). Bond
    masks come from this rank's own stream (bond messages are partitioned
    disjointly). Window-resident tensors repeat the halo atoms on two
    shards, so their masks are keyed by global atom row: each draw is one
    ``(num_atoms, width)`` mask from a stream seeded alike on every rank of
    the ep row, sliced at the window; rows past the batch keep. The step
    is then independent of the ep split."""

    def __init__(self, rate: float, bond_seed: int, row_seed: int, t: Dict,
                 device):
        self.keep = 1.0 - rate
        self.device = device
        self.bond_gen = torch.Generator(device=device).manual_seed(
            int(bond_seed))
        self.row_gen = torch.Generator(device=device).manual_seed(
            int(row_seed))
        self.start, self.A = t["win_start"], t["num_atoms"]

    def _apply(self, x, mask):
        return torch.where(mask, x / self.keep, torch.zeros_like(x))

    def bond(self, x):
        mask = torch.rand(x.shape, generator=self.bond_gen,
                          device=self.device) < self.keep
        return self._apply(x, mask)

    def window(self, x):
        full = torch.rand((self.A, x.shape[1]), generator=self.row_gen,
                          device=self.device) < self.keep
        rows = full[self.start:self.start + x.shape[0]]
        if rows.shape[0] < x.shape[0]:
            rows = torch.cat([rows, rows.new_ones(
                (x.shape[0] - rows.shape[0], x.shape[1]))])
        return self._apply(x, rows)


def _halo_encode(enc, t: Dict, mesh: Mesh, axis: str,
                 strip_width: Optional[int] = None,
                 drop: Optional[_WindowDropout] = None) -> torch.Tensor:
    """One rank's part of the edge-partitioned encoder (JAX
    partition.py:730-858): bond or atom messages, ``undirected``, window
    atom descriptors (``W_d``) and dropout; returns the molecule
    embeddings, all-reduced over the ep ranks. Linear layers compute
    float32, as the JAX package's halo encoder does."""
    cfg = enc.cfg
    act = get_activation(cfg.activation)
    H = cfg.hidden_size
    Aw = t["f_atoms_win"].shape[0]
    rowptr, dst = t["rowptr"], t["dst_sorted"]
    w_sorted, src, srev = t["w_sorted"], t["src_sorted"], t["srev"]
    ones = (dst > 0).float()
    n_ep = mesh.shape[axis]

    if n_ep == 1:
        def combine(read, w):
            return read(w)[1:]
    elif strip_width is None:
        def combine(read, w):
            return _HaloCombineFn.apply(read(w)[1:], mesh, axis,
                                        t["off_prev"], t["off_next"])
    else:
        sw = strip_width
        local = dst - 1            # padding bonds: -1, weight 0
        in_strip = ((local < sw) | (local >= t["ext"] - sw)).float()
        start = min(max(t["ext"] - sw, 0), Aw - sw)
        place = min(max(t["ext_prev"] - sw, 0), Aw - sw)

        def combine(read, w):
            strip = read(w * in_strip)[1:]
            pending = exchange(mesh, axis, strip[:sw].detach(),
                               strip[start:start + sw].detach())
            interior = read(w * (1.0 - in_strip))[1:]
            return _HaloCombineOverlapFn.apply(
                interior, strip, pending, mesh, axis, t["off_prev"],
                t["off_next"], sw, start, place)

    drop_bond = drop.bond if drop is not None else (lambda x: x)
    drop_win = drop.window if drop is not None else (lambda x: x)
    f_bonds = t["f_bonds_sorted"]
    if cfg.atom_messages:
        inputs = linear(enc.W_i, t["f_atoms_win"])
        message = act(inputs)
        w_h = enc.W_h.weight
        f_sum = combine(lambda w: bm.atom_readout(
            f_bonds[:, -cfg.bond_fdim:].contiguous(), w, rowptr), ones)
        const = dense(f_sum, w_h[:, H:], enc.W_h.bias)
        aux = {"src_sorted": src, "rowptr": rowptr, "srev": srev}
        zero = message.new_zeros((1, H))

        def neighbours(h_full):
            def read(w):
                if strip_width is None:
                    return bm.atom_neighbor_sum_sorted(h_full, aux)
                return bm.src_readout_sorted(h_full, dict(aux, w_sorted=w))
            return read

        for _ in range(cfg.depth - 1):
            m = combine(neighbours(torch.cat([zero, message])), ones)
            message = drop_win(act(inputs + dense(m, w_h[:, :H]) + const))
        h_full = torch.cat([zero, message])
        a_win = combine(lambda w: bm.src_readout_sorted(
            h_full, dict(aux, w_sorted=w)), w_sorted)
    else:
        inputs = linear(enc.W_i, f_bonds)
        message = act(inputs)
        zero = message.new_zeros((1, H))
        for _ in range(cfg.depth - 1):
            if cfg.undirected:
                # reverse pairs share a shard: the symmetrization is local
                message = (message + bm.permute_rows(message, srev, srev)) / 2
            a_win = combine(lambda w: bm.atom_readout(
                message, w, rowptr, dst), w_sorted)
            z = (_SrcGatherFn.apply(torch.cat([zero, a_win]), src, srev,
                                    rowptr)
                 - bm.permute_rows(message, srev, srev))
            message = drop_bond(act(inputs + linear(enc.W_h, z)))
        a_win = combine(lambda w: bm.atom_readout(message, w, rowptr, dst),
                        w_sorted)
    atom_hiddens = drop_win(act(linear(
        enc.W_o, torch.cat([t["f_atoms_win"], a_win], 1))))
    if "atom_desc_win" in t:
        atom_hiddens = drop_win(linear(
            enc.W_d, torch.cat([atom_hiddens, t["atom_desc_win"]], 1)))
    return _molecule_readout(atom_hiddens, t, cfg, mesh.group(axis))


def _molecule_readout(atom_hiddens, t, cfg, group) -> torch.Tensor:
    """The owned atoms' weighted molecule sums, all-reduced over ``group``
    together with the weight sums, then the aggregation and the
    degree-of-polymerization scale (JAX partition.py:843-858)."""
    wsum = bm.molecule_sum(atom_hiddens, t["own_w"], t["a2mol_win"],
                           t["mol_idx"], t["mol_rowptr"])
    return _aggregate(wsum, t["mol_denom"], t["degree_of_polym"], cfg,
                      group)


def _aggregate(wsum, denom, degree_of_polym, cfg, group) -> torch.Tensor:
    packed = _psum(torch.cat([wsum, denom[:, None]], 1), group)
    return bm.aggregate_molecules(packed[:, :-1], packed[:, -1].detach(),
                                  degree_of_polym, cfg.aggregation,
                                  cfg.aggregation_norm)


# ---------------------------------------------------------------------------
# the edge-parallel forwards
# ---------------------------------------------------------------------------

def make_edge_parallel_forward(cfg, mesh: Mesh, axis: str = "ep"):
    """Encoder forward over :func:`build_edge_shards` shards, the partials
    all-reduced every layer (JAX partition.py:86-118). Returns
    ``forward(encoder, sharded, replicated) -> (M, H)``, the same on every
    ep rank; ``encoder`` is an ``MPNEncoder`` with config ``cfg``, and the
    shard's CSR runs over the whole atom axis."""
    act = get_activation(cfg.activation)

    def forward(enc, sharded, replicated):
        dev = _device_of(enc)
        sh = _take(sharded, mesh.coord(axis))
        A = replicated["f_atoms"].shape[0]
        aux = build_sorted_aux(sh["b2dst"].astype(np.int32),
                               sh["b2revb_local"], sh["w_bonds"],
                               num_atoms=A)
        M = replicated["degree_of_polym"].shape[0]
        w_atoms = np.asarray(replicated["w_atoms"])
        t = _tensors({"f_bonds_sorted": sh["f_bonds"][aux.perm],
                      **{k: getattr(aux, k) for k in _CSR_KEYS[1:]},
                      "f_atoms": replicated["f_atoms"],
                      "w_atoms": w_atoms, "a2mol": replicated["a2mol"],
                      "degree_of_polym": replicated["degree_of_polym"],
                      **build_molecule_csr(replicated["a2mol"], w_atoms, M,
                                           rows=np.nonzero(w_atoms != 0)[0])},
                     dev)
        group = mesh.group(axis)
        rowptr, dst, srev = t["rowptr"], t["dst_sorted"], t["srev"]
        inputs = linear(enc.W_i, t["f_bonds_sorted"])
        message = act(inputs)
        for _ in range(cfg.depth - 1):
            a_message = _psum(bm.atom_readout(message, t["w_sorted"], rowptr,
                                              dst), group)
            z = (_SrcGatherFn.apply(a_message, t["src_sorted"], srev, rowptr)
                 - bm.permute_rows(message, srev, srev))
            message = act(inputs + linear(enc.W_h, z))
        a_message = _psum(bm.atom_readout(message, t["w_sorted"], rowptr,
                                          dst), group)
        atom_hiddens = act(linear(enc.W_o,
                                  torch.cat([t["f_atoms"], a_message], 1)))
        # replicated atoms: every rank reads the whole molecule readout
        wsum = bm.molecule_sum(atom_hiddens, t["w_atoms"], t["a2mol"],
                               t["mol_idx"], t["mol_rowptr"])
        return _aggregate(wsum, t["mol_denom"], t["degree_of_polym"], cfg,
                          None)

    return forward


def make_edge_parallel_forward_halo(cfg, mesh: Mesh, axis: str = "ep"):
    """Encoder forward over halo shards (JAX partition.py:314-363): a
    neighbour exchange of ``(Aw, H)`` window partials a layer instead of a
    whole-axis all-reduce; only the ``(M, H)`` molecule readout is
    all-reduced. Takes either shard layout (``build_edge_shards_halo`` or
    ``_band``). Returns ``forward(encoder, sharded, replicated)``."""
    return _halo_forward(mesh, axis, None)


def make_edge_parallel_forward_halo_band(cfg, mesh: Mesh, axis: str = "ep"):
    """The JAX package's banded halo forward (partition.py:478-557): on the
    port every halo form aggregates on row 3's kernel over the shard CSR,
    so this is :func:`make_edge_parallel_forward_halo`, given
    :func:`build_edge_shards_halo_band` shards whose CSR is built ahead."""
    return _halo_forward(mesh, axis, None)


def make_edge_parallel_forward_halo_overlap(cfg, mesh: Mesh,
                                            strip_width: int,
                                            axis: str = "ep"):
    """:func:`make_edge_parallel_forward_halo` with the strip exchange
    (JAX partition.py:611-682). Row 3 runs twice a layer, on the strip
    bonds' weights ``w * in_strip`` and the interior's ``w * (1 -
    in_strip)``; every atom's bonds are all in one of the two, so each row
    keeps its summation order and the output is row-exact against the
    whole-window exchange."""
    return _halo_forward(mesh, axis, strip_width)


def _halo_forward(mesh: Mesh, axis: str, strip_width: Optional[int]):
    def forward(enc, sharded, replicated):
        t = _prepare_halo(_take(sharded, mesh.coord(axis)), replicated,
                          _device_of(enc))
        return _halo_encode(enc, t, mesh, axis, strip_width)

    return forward


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def flat_all_reduce(group, scale: float = 1.0):
    """A ``TrainStep`` reduce hook: the gradients of every parameter (zeros
    for one without) and the loss summed over ``group`` in one flat
    all-reduce, times ``scale``; returns the reduced loss."""
    def reduce(params: List[torch.Tensor], loss: torch.Tensor):
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params] + [loss.detach().reshape(1)])
        flat = all_reduce_sum(flat, group)
        if scale != 1.0:
            flat = flat * scale
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return flat[-1]

    return reduce


def make_halo_train_step(model, optimizer, schedule, mesh: Mesh,
                         axis: str = "ep", target_weights=None,
                         grad_clip: Optional[float] = None):
    """A training step with the encoder edge-partitioned over ``axis``
    (JAX partition.py:366-412): the halo forward, then the FFN (no
    dropout) and the masked loss on the replicated embeddings; gradients
    flow back through the exchanges. Single molecule position. Returns
    ``step(sharded, replicated, targets, mask, weights) -> (loss,
    gnorm)``; either shard layout works."""
    from ..train.loss import get_loss_fn, masked_loss
    from ..train.step import TrainStep

    cfg = model.cfg
    elementwise = get_loss_fn(cfg.dataset_type, None)
    n_ep = mesh.shape[axis]

    def loss_fn(model, batch, generator):
        t = batch["shard"]
        emb = _halo_encode(model.encoders[0], t, mesh, axis)
        model.eval()
        preds = model.apply_ffn(emb)
        elem = elementwise(preds, batch["targets"])
        return masked_loss(elem, batch["mask"], target_weights,
                           batch["weights"]) / n_ep

    inner = TrainStep(model, optimizer, schedule, loss_fn,
                      grad_clip=grad_clip,
                      reduce=flat_all_reduce(mesh.group(axis)))

    def step(sharded, replicated, targets, mask, weights):
        dev = _device_of(model)
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                         device=dev)
        return inner({"shard": _prepare_halo(
            _take(sharded, mesh.coord(axis)), replicated, dev),
            "targets": as_t(targets), "mask": as_t(mask),
            "weights": as_t(weights)})

    return step


def make_halo_dp_train_step(model, optimizer, schedule, mesh: Mesh,
                            dp_axis: str = "dp", ep_axis: str = "ep",
                            target_weights=None, overlap: bool = False,
                            strip_width: Optional[int] = None,
                            dropout_rngs: bool = False,
                            use_features: bool = False,
                            grad_clip: Optional[float] = None):
    """Training step on a 2-D ``(dp, ep)`` mesh (JAX partition.py:863-955):
    each dp row edge-partitions its own batch over its ep ranks; the loss
    is the exact global masked mean over every row's batch, so the update
    equals a single-device step on the concatenated batches.

    Returns ``step(sharded, replicated, targets, mask, weights, seeds=None,
    ffn_seed=0, features=None) -> (loss, gnorm)``, its ``TrainStep`` as
    ``step.train_step``: ``sharded`` /
    ``replicated`` from :func:`build_edge_shards_halo_dp` (tuples with
    several molecule positions; ``mpn_shared`` honoured), ``targets``,
    ``mask``, ``weights`` ``(n_dp, M, T)``, ``features`` ``(n_dp, M, F)``
    appended before the FFN with ``use_features``. With ``dropout_rngs``,
    ``seeds`` ``(n_dp, n_ep)`` seeds each shard's bond masks, ``seeds[d,
    0]`` the row-keyed window masks of row ``d`` (:class:`_WindowDropout`)
    and ``ffn_seed + d`` its FFN masks. ``strip_width`` None with
    ``overlap`` takes each batch's own :func:`halo_strip_width`."""
    from ..train.loss import get_loss_fn
    from ..train.step import TrainStep

    cfg = model.cfg
    elementwise = get_loss_fn(cfg.dataset_type, None)
    n_ep = mesh.shape[ep_axis]
    rate = cfg.encoder.dropout if dropout_rngs else 0.0

    def loss_fn(model, batch, generator):
        embs = []
        for i, t in enumerate(batch["shards"]):
            enc = model.encoders[0 if cfg.mpn_shared else i]
            drop = (_WindowDropout(rate, batch["seeds"][0],
                                   batch["seeds"][1], t, t["rowptr"].device)
                    if rate > 0 else None)
            embs.append(_halo_encode(enc, t, mesh, ep_axis,
                                     batch["strip_width"], drop))
        emb = torch.cat(embs, 1) if len(embs) > 1 else embs[0]
        if use_features and batch.get("features") is not None:
            emb = torch.cat([emb, batch["features"]], 1)
        model.train(dropout_rngs)
        ffn_gen = None
        if dropout_rngs and cfg.encoder.dropout > 0:
            ffn_gen = torch.Generator(device=emb.device).manual_seed(
                batch["ffn_seed"])
        preds = model.apply_ffn(emb, ffn_gen)
        if cfg.dataset_type == "multiclass":
            preds = preds.reshape(preds.shape[0], -1,
                                  cfg.multiclass_num_classes)
        x = elementwise(preds, batch["targets"]) * batch["mask"] \
            * batch["weights"]
        if target_weights is not None:
            x = x * target_weights
        return x.sum() / max(batch["denom"], 1.0) / n_ep

    inner = TrainStep(model, optimizer, schedule, loss_fn,
                      grad_clip=grad_clip,
                      reduce=flat_all_reduce(mesh.group(None)))

    def step(sharded, replicated, targets, mask, weights, seeds=None,
             ffn_seed: int = 0, features=None):
        if not isinstance(sharded, (tuple, list)):
            sharded, replicated = (sharded,), (replicated,)
        d, e = mesh.coord(dp_axis), mesh.coord(ep_axis)
        dev = _device_of(model)
        sw = None
        if overlap and n_ep > 1:
            sw = strip_width or max(halo_strip_width(s) for s in sharded)
        as_t = lambda x: torch.as_tensor(np.asarray(x)[d],
                                         dtype=torch.float32, device=dev)
        batch = {
            "shards": [_prepare_halo(_take(sh, (d, e)), _take(rep, d), dev)
                       for sh, rep in zip(sharded, replicated)],
            "targets": as_t(targets), "mask": as_t(mask),
            "weights": as_t(weights),
            # the global denominator, from every row's mask on the host
            "denom": float(np.asarray(mask, np.float32).sum()),
            "strip_width": sw, "ffn_seed": int(ffn_seed) + d,
            "seeds": ((int(seeds[d][e]), int(seeds[d][0]))
                      if seeds is not None else (0, 0)),
        }
        if features is not None:
            batch["features"] = as_t(features)
        return inner(batch)

    step.train_step = inner
    return step
