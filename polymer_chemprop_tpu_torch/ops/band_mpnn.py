"""The encoder's message-passing kernels: wrappers, plain versions, autograd.

* :func:`band_rev_layer`: one whole depth-loop layer over dst-sorted bonds,
  ``out = act(inp + z @ W_h)`` with
  ``z[t] = sum_{c in run(src t)} w[c] m[c] - m[srev t]``
  (csrc/band_rev_layer.cu; replaces the JAX package's
  ``_band_rev_act_kernel``). Differentiable in ``m``, ``W_h`` and ``inp``.
* :func:`band_rev_bwd`: ``dm = M^T g``, the VJP of ``z = M m``,
  ``dm[c] = w[c] * sum_{c' in run(dst c)} g[srev c'] - g[srev c]``
  (csrc/band_rev_bwd.cu; replaces ``_band_rev_bwd_kernel``).
* :func:`atom_readout`: ``a[v] = sum_{c in run(v)} w[c] m[c]``
  (csrc/atom_readout.cu; replaces ``_atom_band_kernel``). Differentiable
  in ``m``.

* :func:`band_agg`: the plain band aggregation ``z = S m - m``,
  ``z[c] = sum_{c' in run(dst c)} w[c'] m[c'] - m[c]`` (csrc/band_agg.cu;
  replaces ``_band_kernel``). Differentiable in ``m``.
* :func:`band_bwd`: ``dm = S^T g - g``,
  ``dm[c] = w[c] * sum_{b in run(dst c)} g[b] - g[c]``, the VJP of the plain
  band aggregation in every form (csrc/band_bwd.cu; replaces
  ``_band_bwd_kernel``).
* :func:`band_matmul_act`: ``act(inp_srev + z @ W_h)`` with ``z = S m - m``
  (csrc/band_matmul.cu; replaces ``_band_matmul_act_kernel``), and
  :func:`band_matmul`: ``z @ W_h`` (the same source's second function;
  replaces ``_band_matmul_kernel``). Differentiable in ``m``, ``W_h`` and
  ``inp_srev``.

* :func:`atom_neighbor_sum_sorted`: ``out[v] = sum_{c in run(v)} h[src c]``
  and :func:`src_readout_sorted`: ``a[v] = sum_{c in run(v)} w[c] h[src c]``
  over an (A, H) atom table ``h``, the ``atom_messages`` encoder's layer
  sum and readout: the gather entry of csrc/atom_readout.cu
  (``atom_gather_readout_f32``; the JAX package composes the gather
  ``h[src_sorted]`` with ``_atom_band_kernel``), which never writes the
  gathered (B, H) rows. Differentiable in ``h``, each VJP on the same
  kernel (the readout's reads its weights ``w[srev]`` through the entry's
  weight index). :func:`csr_gather_sum` is that entry over any row table,
  forward only: the edge-partitioned encoder's gather VJP (bond rows by
  ``srev``, parallel/partition.py).
* :func:`molecule_readout_sorted`: the stoichiometry-weighted molecule
  readout, ``sum_{r in mol m} w[r] h[r]`` over the molecule CSR of
  ops/sorted_aux.py (``build_molecule_csr``) and the aggregation
  (:func:`aggregate_molecules`) in one launch of the same source's
  ``molecule_readout_f32`` (the weights read through the CSR's index,
  the aggregation on the sum in registers); :func:`molecule_sum` is the
  sum alone (the edge-partitioned encoder's), the gather entry with its
  weights read through the CSR's index. Both count their launches in
  ``molecule_readout_sorted.launches``. The VJP is autograd's
  through the aggregation, then the row gather ``w[r] g[a2mol r]``.
  Every encoder that has the batch's sorted layout reads out through it,
  so no float sum of the port's message passing is an atomic add: each
  runs in a fixed order, and two runs on the card agree bit for bit.

* :func:`band_message_step_sorted`, :func:`band_matmul_step_sorted` and
  :func:`band_matmul_act_step_sorted`: the JAX package's public ops of the
  same names, each one of the above followed by the ``srev`` row gather
  :func:`permute_rows`, which stays outside the kernels;
  :func:`bond_message_step_natural` the first in natural bond order.

The three W_h-fused kernels (:func:`band_rev_layer`,
:func:`band_matmul_act`, :func:`band_matmul`) take a ``precision``, the JAX
package's ``band_precision``: ``"highest"`` (the default, as the JAX ops')
takes the FP32 product (entry points ``*_f32``); ``"high"`` the split-bf16
product ``z_hi W_hi + z_hi W_lo + z_lo W_hi`` and ``"default"``
``z_hi W_hi``, both on the tensor cores (``*_tc``,
csrc/band_tile_sm90.cuh); :func:`split_matmul` is their plain product. z
is the FP32 aggregation at every precision, and the backward is FP32 at
every precision. The bandwidth kernels (:func:`band_rev_bwd`,
:func:`atom_readout`, :func:`band_agg`, :func:`band_bwd` and the gather
entry) are FP32.

:func:`atom_readout` and :func:`band_agg` read the runs through
csrc/csr_rows.cuh, one thread per (atom, column chunk).

``run(v)`` is the CSR run ``[rowptr[v], rowptr[v + 1])`` of
:mod:`.sorted_aux`. Padding rows lie in no run: the plain band forms give
them ``z = -m`` and ``dm = -g``. A wrapper given CPU tensors computes the
plain PyTorch version beside it; given CUDA tensors it launches its kernel
on the current stream or raises. There is no fallback from one to the
other. Each wrapper counts its kernel launches in ``<wrapper>.launches``;
the three W_h-fused ones count their tensor-core launches once more in
``<wrapper>.tc_launches`` (:func:`tc_launch_counts`).

The gradients are hand-written ``torch.autograd.Function``s that mirror the
JAX package's ``custom_vjp``s (pallas_mpnn.py:664-676, 806-829, 966-986,
1251-1274, 1378-1395, 1455-1525) and run the same formulas on both
devices: on CPU tensors only the kernels are replaced by their plain
versions.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.nn import get_activation

# activation ids shared with the CUDA epilogue (csrc/band_rev_layer.cu)
ACT_IDS = {"relu": 0, "leakyrelu": 1, "prelu": 2, "tanh": 3, "elu": 4,
           "selu": 5}
_SELU_L = 1.0507009873554805
_SELU_AL = 1.6732632423543772 * _SELU_L
# band_precision -> bf16 passes of the tensor-core product; "highest" is
# the FP32 product
TC_PASSES = {"high": 3, "default": 1}
PRECISIONS = ("high", "highest", "default")


# tile geometry of csrc/band_tile.cuh (ROWS, KS, NCHUNK) and the shared
# memory one block may use on Hopper
_TILE_ROWS, _TILE_KS, _TILE_NCHUNK = 32, 32, 320
SMEM_PER_BLOCK = 227 * 1024


def fused_layer_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory the W_h-fused kernels need at width
    ``hidden``: the arithmetic of band_tile.cuh ``smem_bytes``."""
    return 4 * (_TILE_ROWS * hidden + _TILE_KS * _TILE_NCHUNK + _TILE_ROWS)


def fused_layer_fits(hidden: int) -> bool:
    """Whether the W_h-fused kernels (band_rev_layer, band_matmul_act,
    band_matmul) can hold their z tile at this width (up to 1,495). Decided
    from the shape alone, so the CPU takes the same layer form as the
    card."""
    return fused_layer_smem_bytes(hidden) <= SMEM_PER_BLOCK


# geometry of csrc/band_tile_sm90.cuh: rows per block, depth per chunk,
# output columns per pass, and a (pass, chunk) slice of the split W_h
_TC_ROWS, _TC_KC, _TC_NP = 64, 64, 304
_TC_SLICE_BYTES = 2 * _TC_NP * 2 * _TC_KC
# the tensor-core stage's fixed shared memory (band_tile_sm90.cuh
# SMEM_BYTES): alignment slack, two stages of z and W_h halves, two
# mbarriers, two ints a row
TC_SMEM_BYTES = (1024 + 2 * (2 * _TC_ROWS * 2 * _TC_KC + _TC_SLICE_BYTES)
                 + 8 * 2 + 8 * _TC_ROWS)


def tc_scratch_bytes(hidden: int) -> int:
    """Bytes of the split-W_h scratch the tensor-core entry points take:
    one slice per (pass, chunk) (band_tile_sm90.cuh ``scratch_bytes``)."""
    return (-(-hidden // _TC_NP)) * (-(-hidden // _TC_KC)) * _TC_SLICE_BYTES


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"band_precision {precision!r}: expected one of "
                         f"{PRECISIONS}")


def split_bf16(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` bf16 halves of a float32 tensor, each rounded to
    nearest even: ``hi = bf16(w)``, ``lo = bf16(w - hi)`` (the split of
    pallas_mpnn.py ``_dot_band`` and fused_matmul_probe.py)."""
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


@contextlib.contextmanager
def float32_matmul_precision(level: str):
    """``torch.set_float32_matmul_precision(level)`` inside the block only:
    "highest" is full float32, "high" lets cuBLAS use TF32."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(level)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def split_matmul(a: torch.Tensor, b: torch.Tensor, passes: int
                 ) -> torch.Tensor:
    """``a_hi b_hi + a_hi b_lo + a_lo b_hi`` (``passes=3``) or ``a_hi b_hi``
    (``passes=1``) for float32 ``a`` and ``b`` split by :func:`split_bf16`:
    the rounded halves multiplied as float32 with TF32 off, added in
    pallas_mpnn.py ``_dot_band``'s order."""
    a_hi, a_lo = (t.float() for t in split_bf16(a))
    b_hi, b_lo = (t.float() for t in split_bf16(b))
    with float32_matmul_precision("highest"):
        out = a_hi @ b_hi
        if passes == 3:
            out = out + a_hi @ b_lo
            out = out + a_lo @ b_hi
    return out


def band_product(z: torch.Tensor, wh: torch.Tensor, precision: str
                 ) -> torch.Tensor:
    """``z @ W_h`` at ``band_precision``: FP32 at ``"highest"``, else
    :func:`split_matmul`."""
    check_precision(precision)
    if precision == "highest":
        return z @ wh
    return split_matmul(z, wh, TC_PASSES[precision])


def act_grad_from_output(act: str, a: torch.Tensor) -> torch.Tensor:
    """d act / d pre as a function of the activation OUTPUT ``a`` (every
    supported activation is monotone through 0, so sign(a) == sign(pre));
    pallas_mpnn.py _act_grad_from_output."""
    one = torch.ones((), dtype=a.dtype, device=a.device)
    if act == "relu":
        return (a > 0).to(a.dtype)
    if act == "leakyrelu":
        return torch.where(a > 0, one, 0.1 * one)
    if act == "prelu":
        return torch.where(a > 0, one, 0.25 * one)
    if act == "tanh":
        return 1.0 - a * a
    if act == "elu":
        return torch.where(a > 0, one, a + 1.0)
    if act == "selu":
        return torch.where(a > 0, _SELU_L * one, a + _SELU_AL)
    raise ValueError(f'Activation "{act}" not supported.')


# -- plain versions ----------------------------------------------------------

def _csr_rows(rowptr: torch.Tensor) -> torch.Tensor:
    """Destination atom of each bond in ``[0, rowptr[-1])``."""
    counts = (rowptr[1:] - rowptr[:-1]).long()
    atoms = torch.arange(counts.shape[0], device=rowptr.device)
    return torch.repeat_interleave(atoms, counts)


def dst_from_rowptr(rowptr: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The destination atom of each of ``num_rows`` sorted bonds, 0 on the
    padding rows from ``rowptr[-1]`` on: ops/sorted_aux.py's
    ``dst_sorted``, rebuilt from ``rowptr`` (int64)."""
    rows = _csr_rows(rowptr)
    dst = rows.new_zeros(num_rows)
    dst[:rows.shape[0]] = rows
    return dst


def atom_readout_plain(m: torch.Tensor, w_sorted: torch.Tensor,
                       rowptr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`atom_readout`, with ``index_add_``."""
    A = rowptr.shape[0] - 1
    n = int(rowptr[-1])
    out = m.new_zeros((A, m.shape[1]))
    return out.index_add_(0, _csr_rows(rowptr), m[:n] * w_sorted[:n, None])


def atom_neighbor_sum_plain(h: torch.Tensor, src_sorted: torch.Tensor,
                            rowptr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`atom_neighbor_sum_sorted`, with
    ``index_add_``."""
    A = rowptr.shape[0] - 1
    n = int(rowptr[-1])
    out = h.new_zeros((A, h.shape[1]))
    return out.index_add_(0, _csr_rows(rowptr), h[src_sorted[:n].long()])


def src_readout_plain(h: torch.Tensor, w_sorted: torch.Tensor,
                      src_sorted: torch.Tensor, rowptr: torch.Tensor,
                      widx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`src_readout_sorted`, with ``index_add_``;
    with ``widx`` the weights are read through it, ``w_sorted[widx]`` (the
    gather entry's weight index)."""
    A = rowptr.shape[0] - 1
    n = int(rowptr[-1])
    w = w_sorted[:n] if widx is None else w_sorted[widx[:n].long()]
    out = h.new_zeros((A, h.shape[1]))
    return out.index_add_(0, _csr_rows(rowptr),
                          h[src_sorted[:n].long()] * w[:, None])


def molecule_readout_plain(h: torch.Tensor, w: torch.Tensor,
                           idx: torch.Tensor, rowptr: torch.Tensor,
                           denom: Optional[torch.Tensor],
                           degree_of_polym: Optional[torch.Tensor],
                           aggregation: Optional[str] = "mean",
                           aggregation_norm: float = 100.0) -> torch.Tensor:
    """Plain version of the one-launch molecule readout: the weighted sum
    over the molecule CSR (``w`` read through ``idx``), then
    :func:`aggregate_molecules` unless ``aggregation`` is None."""
    wsum = src_readout_plain(h, w, idx, rowptr, widx=idx)
    if aggregation is None:
        return wsum
    return aggregate_molecules(wsum, denom, degree_of_polym, aggregation,
                               aggregation_norm)


def band_rev_z_plain(m: torch.Tensor, w_sorted: torch.Tensor,
                     src_sorted: torch.Tensor, srev: torch.Tensor,
                     rowptr: torch.Tensor) -> torch.Tensor:
    """``z = M m``: the aggregation inside :func:`band_rev_layer`."""
    a = atom_readout_plain(m, w_sorted, rowptr)
    return a[src_sorted.long()] - m[srev.long()]


def band_rev_layer_plain(m: torch.Tensor, inp: torch.Tensor,
                         wh: torch.Tensor, w_sorted: torch.Tensor,
                         src_sorted: torch.Tensor, srev: torch.Tensor,
                         rowptr: torch.Tensor, act: str,
                         precision: str = "highest") -> torch.Tensor:
    """Plain version of :func:`band_rev_layer`, the product at
    ``precision`` (:func:`band_product`)."""
    z = band_rev_z_plain(m, w_sorted, src_sorted, srev, rowptr)
    return get_activation(act)(inp + band_product(z, wh, precision))


def band_rev_bwd_plain(g: torch.Tensor, w_sorted: torch.Tensor,
                       srev: torch.Tensor, rowptr: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of :func:`band_rev_bwd`."""
    A = rowptr.shape[0] - 1
    n = int(rowptr[-1])
    rows = _csr_rows(rowptr)
    g_rev = g[srev.long()]
    s = g.new_zeros((A, g.shape[1])).index_add_(0, rows, g_rev[:n])
    dm = -g_rev
    dm[:n] += w_sorted[:n, None] * s[rows]
    return dm


def band_agg_plain(m: torch.Tensor, w_sorted: torch.Tensor,
                   rowptr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`band_agg`: ``z = S m - m``."""
    n = int(rowptr[-1])
    a = atom_readout_plain(m, w_sorted, rowptr)
    return torch.cat([a[_csr_rows(rowptr)] - m[:n], -m[n:]])


def band_bwd_plain(g: torch.Tensor, w_sorted: torch.Tensor,
                   rowptr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`band_bwd`: ``dm = w o (K g) - g``."""
    A = rowptr.shape[0] - 1
    n = int(rowptr[-1])
    rows = _csr_rows(rowptr)
    s = g.new_zeros((A, g.shape[1])).index_add_(0, rows, g[:n])
    return torch.cat([w_sorted[:n, None] * s[rows] - g[:n], -g[n:]])


def band_matmul_plain(m: torch.Tensor, wh: torch.Tensor,
                      w_sorted: torch.Tensor, rowptr: torch.Tensor,
                      precision: str = "highest"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`band_matmul_forward`: ``(z @ W_h, z)``, the
    product at ``precision`` (:func:`band_product`)."""
    z = band_agg_plain(m, w_sorted, rowptr)
    return band_product(z, wh, precision), z


def band_matmul_act_plain(m: torch.Tensor, inp_srev: torch.Tensor,
                          wh: torch.Tensor, w_sorted: torch.Tensor,
                          rowptr: torch.Tensor, act: str,
                          precision: str = "highest") -> torch.Tensor:
    """Plain version of :func:`band_matmul_act`."""
    z = band_agg_plain(m, w_sorted, rowptr)
    return get_activation(act)(inp_srev + band_product(z, wh, precision))


# -- wrappers ----------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def _check_fits(kernel: str, hidden: int) -> None:
    if not fused_layer_fits(hidden):
        raise ValueError(
            f"{kernel}: hidden size {hidden} needs "
            f"{fused_layer_smem_bytes(hidden)} bytes of shared memory, more "
            f"than a block's {SMEM_PER_BLOCK}; the encoder takes the unfused "
            "layer form (band_agg) at this width")


def band_rev_layer_forward(m: torch.Tensor, inp: torch.Tensor,
                           wh: torch.Tensor, w_sorted: torch.Tensor,
                           src_sorted: torch.Tensor, srev: torch.Tensor,
                           rowptr: torch.Tensor, act: str, want_z: bool,
                           precision: str = "highest"
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer without autograd: ``(out, z)`` with ``z = M m`` written
    only when ``want_z`` (training), else ``(out, None)``. ``precision``
    picks the FP32 entry (``"highest"``) or the tensor-core one."""
    act = act.lower()
    if act not in ACT_IDS:
        raise ValueError(f'Activation "{act}" not supported.')
    check_precision(precision)
    if m.device.type == "cpu":
        z = band_rev_z_plain(m, w_sorted, src_sorted, srev, rowptr)
        out = get_activation(act)(inp + band_product(z, wh, precision))
        return out, (z if want_z else None)
    if m.device.type != "cuda":
        raise ValueError(f"band_rev_layer: unsupported device {m.device}")
    B, H = m.shape
    dev = m.device
    _check("m", m, (B, H), torch.float32, dev)
    _check("inp", inp, (B, H), torch.float32, dev)
    _check("wh", wh, (H, H), torch.float32, dev)
    _check("w_sorted", w_sorted, (B,), torch.float32, dev)
    _check("src_sorted", src_sorted, (B,), torch.int32, dev)
    _check("srev", srev, (B,), torch.int32, dev)
    _check("rowptr", rowptr, (rowptr.shape[0],), torch.int32, dev)
    _check_fits("band_rev_layer", H)
    from ..kernels.build import load
    lib = load("band_rev_layer")
    out = torch.empty_like(m)
    z = torch.empty_like(m) if want_z else None
    z_ptr = z.data_ptr() if want_z else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if precision == "highest":
            err = lib.band_rev_layer_f32(
                m.data_ptr(), inp.data_ptr(), wh.data_ptr(),
                w_sorted.data_ptr(), src_sorted.data_ptr(), srev.data_ptr(),
                rowptr.data_ptr(), out.data_ptr(), z_ptr, B, H, ACT_IDS[act],
                stream)
        else:
            # W_h split into bf16 halves, padded and swizzled, per call
            scratch = torch.empty(tc_scratch_bytes(H), dtype=torch.uint8,
                                  device=dev)
            err = lib.band_rev_layer_tc(
                m.data_ptr(), inp.data_ptr(), wh.data_ptr(),
                scratch.data_ptr(), w_sorted.data_ptr(),
                src_sorted.data_ptr(), srev.data_ptr(), rowptr.data_ptr(),
                out.data_ptr(), z_ptr, B, H, ACT_IDS[act],
                TC_PASSES[precision], stream)
    _raise_on(err, "band_rev_layer")
    band_rev_layer.launches += 1
    if precision != "highest":
        band_rev_layer.tc_launches += 1
    return out, z


def band_rev_bwd(g: torch.Tensor, w_sorted: torch.Tensor,
                 srev: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """``dm = M^T g``, the VJP of the layer's aggregation ``z = M m``.

    g: (B, H) f32; w_sorted: (B,) f32; srev: (B,) int32; rowptr: (A + 1,)
    int32. Padding rows come out as ``-g``."""
    if g.device.type == "cpu":
        return band_rev_bwd_plain(g, w_sorted, srev, rowptr)
    if g.device.type != "cuda":
        raise ValueError(f"band_rev_bwd: unsupported device {g.device}")
    B, H = g.shape
    A = rowptr.shape[0] - 1
    dev = g.device
    _check("g", g, (B, H), torch.float32, dev)
    _check("w_sorted", w_sorted, (B,), torch.float32, dev)
    _check("srev", srev, (B,), torch.int32, dev)
    _check("rowptr", rowptr, (A + 1,), torch.int32, dev)
    from ..kernels.build import load
    lib = load("band_rev_bwd")
    dm = torch.empty_like(g)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.band_rev_bwd_f32(g.data_ptr(), w_sorted.data_ptr(),
                                   srev.data_ptr(), rowptr.data_ptr(),
                                   dm.data_ptr(), A, B, H, stream)
    _raise_on(err, "band_rev_bwd")
    band_rev_bwd.launches += 1
    return dm


def _atom_readout_forward(m: torch.Tensor, w_sorted: torch.Tensor,
                          rowptr: torch.Tensor) -> torch.Tensor:
    if m.device.type == "cpu":
        return atom_readout_plain(m, w_sorted, rowptr)
    if m.device.type != "cuda":
        raise ValueError(f"atom_readout: unsupported device {m.device}")
    B, H = m.shape
    A = rowptr.shape[0] - 1
    dev = m.device
    _check("m", m, (B, H), torch.float32, dev)
    _check("w_sorted", w_sorted, (B,), torch.float32, dev)
    _check("rowptr", rowptr, (A + 1,), torch.int32, dev)
    from ..kernels.build import load
    lib = load("atom_readout")
    out = m.new_empty((A, H))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.atom_readout_f32(m.data_ptr(), w_sorted.data_ptr(),
                                   rowptr.data_ptr(), out.data_ptr(), A, H,
                                   stream)
    _raise_on(err, "atom_readout")
    atom_readout.launches += 1
    return out


def _atom_gather_launch(kernel: str, h: torch.Tensor, idx: torch.Tensor,
                        w: Optional[torch.Tensor], rowptr: torch.Tensor,
                        rows: Optional[int] = None,
                        widx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Checks, allocation and launch of csrc/atom_readout.cu's gather entry
    ``atom_gather_readout_f32``: ``out[v] = sum_{c in run(v)} wt(c)
    h[idx[c]]`` for a table ``h`` of ``rows`` rows (the A atoms unless
    given: :func:`csr_gather_sum` reads bond rows), with ``wt(c)`` 1 when
    ``w`` is None (never read), ``w[c]``, or ``w[widx[c]]`` when ``widx``
    is given (``w`` then has any length)."""
    if h.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {h.device}")
    A = rowptr.shape[0] - 1
    B, H = idx.shape[0], h.shape[1]
    dev = h.device
    _check("h", h, (A if rows is None else rows, H), torch.float32, dev)
    _check("src_sorted", idx, (B,), torch.int32, dev)
    if w is not None:
        _check("w", w, (B if widx is None else w.shape[0],), torch.float32,
               dev)
    if widx is not None:
        _check("widx", widx, (B,), torch.int32, dev)
    _check("rowptr", rowptr, (A + 1,), torch.int32, dev)
    from ..kernels.build import load
    lib = load("atom_readout")
    out = h.new_empty((A, H))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.atom_gather_readout_f32(
            h.data_ptr(), idx.data_ptr(), None if w is None else w.data_ptr(),
            None if widx is None else widx.data_ptr(), rowptr.data_ptr(),
            out.data_ptr(), A, H, stream)
    _raise_on(err, kernel)
    return out


def _atom_gather_forward(wrapper, h: torch.Tensor,
                         w: Optional[torch.Tensor], src_sorted: torch.Tensor,
                         rowptr: torch.Tensor,
                         rows: Optional[int] = None,
                         widx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum of ``wrapper`` (:func:`atom_neighbor_sum_sorted` with ``w``
    None, :func:`src_readout_sorted`; weights ``w[widx]`` with ``widx``):
    its plain version on CPU tensors, else one launch counted in
    ``wrapper.launches``."""
    if h.device.type == "cpu":
        if w is None:
            return atom_neighbor_sum_plain(h, src_sorted, rowptr)
        return src_readout_plain(h, w, src_sorted, rowptr, widx)
    out = _atom_gather_launch(wrapper.__name__, h, src_sorted, w, rowptr,
                              rows, widx)
    wrapper.launches += 1
    return out


# the molecule readout's aggregation ids (csrc/atom_readout.cu Aggregation)
AGGREGATION_IDS = {"mean": 1, "sum": 2, "norm": 3}


def _molecule_readout_launch(h: torch.Tensor, w: torch.Tensor,
                             idx: torch.Tensor, rowptr: torch.Tensor,
                             denom: Optional[torch.Tensor],
                             degree_of_polym: torch.Tensor,
                             aggregation: str = "mean",
                             aggregation_norm: float = 100.0
                             ) -> torch.Tensor:
    """Checks, allocation and one launch of csrc/atom_readout.cu's
    ``molecule_readout_f32`` (uncounted): :func:`molecule_readout_plain`
    on CUDA tensors. h (A, H) f32; w (A,) f32; idx (A,) int32; rowptr
    (M + 1,) int32; denom (``mean``) and degree_of_polym (M,) f32."""
    if h.device.type != "cuda":
        raise ValueError(f"molecule_readout: unsupported device {h.device}")
    if aggregation not in AGGREGATION_IDS:
        raise ValueError(f"unknown aggregation {aggregation!r}")
    A, H = h.shape
    M = rowptr.shape[0] - 1
    dev = h.device
    _check("h", h, (A, H), torch.float32, dev)
    _check("w", w, (A,), torch.float32, dev)
    _check("mol_idx", idx, (idx.shape[0],), torch.int32, dev)
    _check("mol_rowptr", rowptr, (M + 1,), torch.int32, dev)
    _check("degree_of_polym", degree_of_polym, (M,), torch.float32, dev)
    if aggregation == "mean":
        _check("mol_denom", denom, (M,), torch.float32, dev)
    # torch's CUDA division by a Python scalar multiplies by its float
    # reciprocal, computed on the host in float
    inv_norm = float(np.float32(1.0) / np.float32(aggregation_norm))
    from ..kernels.build import load
    lib = load("atom_readout")
    out = h.new_empty((M, H))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.molecule_readout_f32(
            h.data_ptr(), idx.data_ptr(), w.data_ptr(), rowptr.data_ptr(),
            denom.data_ptr() if aggregation == "mean" else None,
            degree_of_polym.data_ptr(), out.data_ptr(), M, H,
            AGGREGATION_IDS[aggregation], inv_norm, stream)
    _raise_on(err, "molecule_readout")
    return out


def _band_rows_launch(kernel: str, x: torch.Tensor, w_sorted: torch.Tensor,
                      rowptr: torch.Tensor) -> torch.Tensor:
    """Checks, allocation and launch shared by csrc/band_agg.cu and
    csrc/band_bwd.cu, whose entry points ``<kernel>_f32`` take the same
    arguments: (B, H) rows in, (B, H) rows out."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    B, H = x.shape
    A = rowptr.shape[0] - 1
    dev = x.device
    _check("m" if kernel == "band_agg" else "g", x, (B, H), torch.float32,
           dev)
    _check("w_sorted", w_sorted, (B,), torch.float32, dev)
    _check("rowptr", rowptr, (A + 1,), torch.int32, dev)
    from ..kernels.build import load
    lib = load(kernel)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{kernel}_f32")(
            x.data_ptr(), w_sorted.data_ptr(), rowptr.data_ptr(),
            out.data_ptr(), A, B, H, stream)
    _raise_on(err, kernel)
    return out


def _band_agg_forward(m: torch.Tensor, w_sorted: torch.Tensor,
                      rowptr: torch.Tensor) -> torch.Tensor:
    if m.device.type == "cpu":
        return band_agg_plain(m, w_sorted, rowptr)
    z = _band_rows_launch("band_agg", m, w_sorted, rowptr)
    band_agg.launches += 1
    return z


def band_bwd(g: torch.Tensor, w_sorted: torch.Tensor,
             rowptr: torch.Tensor) -> torch.Tensor:
    """``dm = S^T g - g``, the VJP of the plain band aggregation
    ``z = S m - m``: the run's cotangents summed with unit weights, scaled
    by the row's own weight.

    g: (B, H) f32; w_sorted: (B,) f32; rowptr: (A + 1,) int32. Padding rows
    come out as ``-g``."""
    if g.device.type == "cpu":
        return band_bwd_plain(g, w_sorted, rowptr)
    dm = _band_rows_launch("band_bwd", g, w_sorted, rowptr)
    band_bwd.launches += 1
    return dm


def _band_matmul_launch(kernel: str, m: torch.Tensor,
                        inp_srev: Optional[torch.Tensor], wh: torch.Tensor,
                        w_sorted: torch.Tensor, rowptr: torch.Tensor,
                        act_id: int, want_z: bool, precision: str
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Checks, allocation and launch shared by the entry points of
    csrc/band_matmul.cu; ``inp_srev`` None selects ``band_matmul_*``,
    ``precision`` the FP32 (``*_f32``) or the tensor-core (``*_tc``)
    entry."""
    if m.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {m.device}")
    B, H = m.shape
    A = rowptr.shape[0] - 1
    dev = m.device
    _check("m", m, (B, H), torch.float32, dev)
    if inp_srev is not None:
        _check("inp_srev", inp_srev, (B, H), torch.float32, dev)
    _check("wh", wh, (H, H), torch.float32, dev)
    _check("w_sorted", w_sorted, (B,), torch.float32, dev)
    _check("rowptr", rowptr, (A + 1,), torch.int32, dev)
    _check_fits(kernel, H)
    from ..kernels.build import load
    lib = load("band_matmul")
    out = torch.empty_like(m)
    z = torch.empty_like(m) if want_z else None
    z_ptr = z.data_ptr() if want_z else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if precision == "highest":
            if inp_srev is None:
                err = lib.band_matmul_f32(
                    m.data_ptr(), wh.data_ptr(), w_sorted.data_ptr(),
                    rowptr.data_ptr(), out.data_ptr(), z_ptr, A, B, H,
                    stream)
            else:
                err = lib.band_matmul_act_f32(
                    m.data_ptr(), inp_srev.data_ptr(), wh.data_ptr(),
                    w_sorted.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
                    z_ptr, A, B, H, act_id, stream)
        else:
            # W_h split into bf16 halves, padded and swizzled, per call
            scratch = torch.empty(tc_scratch_bytes(H), dtype=torch.uint8,
                                  device=dev)
            passes = TC_PASSES[precision]
            if inp_srev is None:
                err = lib.band_matmul_tc(
                    m.data_ptr(), wh.data_ptr(), scratch.data_ptr(),
                    w_sorted.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
                    z_ptr, A, B, H, passes, stream)
            else:
                err = lib.band_matmul_act_tc(
                    m.data_ptr(), inp_srev.data_ptr(), wh.data_ptr(),
                    scratch.data_ptr(), w_sorted.data_ptr(),
                    rowptr.data_ptr(), out.data_ptr(), z_ptr, A, B, H,
                    act_id, passes, stream)
    _raise_on(err, kernel)
    return out, z


def band_matmul_act_forward(m: torch.Tensor, inp_srev: torch.Tensor,
                            wh: torch.Tensor, w_sorted: torch.Tensor,
                            rowptr: torch.Tensor, act: str, want_z: bool,
                            precision: str = "highest"
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`band_matmul_act` without autograd: ``(out, z)`` with
    ``z = S m - m`` written only when ``want_z`` (training), else
    ``(out, None)``."""
    act = act.lower()
    if act not in ACT_IDS:
        raise ValueError(f'Activation "{act}" not supported.')
    check_precision(precision)
    if m.device.type == "cpu":
        z = band_agg_plain(m, w_sorted, rowptr)
        out = get_activation(act)(inp_srev + band_product(z, wh, precision))
        return out, (z if want_z else None)
    out, z = _band_matmul_launch("band_matmul_act", m, inp_srev, wh, w_sorted,
                                 rowptr, ACT_IDS[act], want_z, precision)
    band_matmul_act.launches += 1
    if precision != "highest":
        band_matmul_act.tc_launches += 1
    return out, z


def band_matmul_forward(m: torch.Tensor, wh: torch.Tensor,
                        w_sorted: torch.Tensor, rowptr: torch.Tensor,
                        precision: str = "highest"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`band_matmul` without autograd: ``(z @ W_h, z)`` with
    ``z = S m - m``; both are always written, as by the TPU kernel."""
    check_precision(precision)
    if m.device.type == "cpu":
        return band_matmul_plain(m, wh, w_sorted, rowptr, precision)
    out, z = _band_matmul_launch("band_matmul", m, None, wh, w_sorted, rowptr,
                                 0, True, precision)
    band_matmul.launches += 1
    if precision != "highest":
        band_matmul.tc_launches += 1
    return out, z


# -- autograd ----------------------------------------------------------------

class _BandRevLayerFn(torch.autograd.Function):
    """``act(inp + (M m) @ W_h)`` with the VJP of
    band_rev_layer_step_sorted: ``z`` is written only when a gradient is
    wanted, and the backward needs no pre-activation (the activation's
    derivative is taken from its output). The backward is FP32 at every
    precision."""

    @staticmethod
    def forward(ctx, m, wh, inp, w_sorted, src_sorted, srev, rowptr, act,
                precision):
        want_z = any(ctx.needs_input_grad[:3])
        out, z = band_rev_layer_forward(m, inp, wh, w_sorted, src_sorted,
                                        srev, rowptr, act, want_z, precision)
        if want_z:
            ctx.save_for_backward(z, wh, out, w_sorted, srev, rowptr)
            ctx.act = act.lower()
        return out

    @staticmethod
    def backward(ctx, g):
        z, wh, out, w_sorted, srev, rowptr = ctx.saved_tensors
        need_m, need_wh, need_inp = ctx.needs_input_grad[:3]
        g_pre = g * act_grad_from_output(ctx.act, out)
        dwh = z.t() @ g_pre if need_wh else None
        dm = None
        if need_m:
            gw = (g_pre @ wh.t()).contiguous()
            dm = band_rev_bwd(gw, w_sorted, srev, rowptr)
        return (dm, dwh, g_pre if need_inp else None,
                None, None, None, None, None, None)


class _AtomReadoutFn(torch.autograd.Function):
    """Weighted incoming sum per atom; its VJP is the weighted row gather
    ``dm = w * g[dst]`` in PyTorch ops, as in the JAX package."""

    @staticmethod
    def forward(ctx, m, w_sorted, rowptr, dst_sorted):
        ctx.save_for_backward(w_sorted, dst_sorted)
        return _atom_readout_forward(m, w_sorted, rowptr)

    @staticmethod
    def backward(ctx, g):
        w_sorted, dst_sorted = ctx.saved_tensors
        return w_sorted[:, None] * g[dst_sorted.long()], None, None, None


class _AtomNeighborSumFn(torch.autograd.Function):
    """``out = N h`` with N the atom adjacency counted by bonds, which is
    symmetric: the VJP is the same sum of the cotangent, ``dh = N g``, on
    the same kernel (pallas_mpnn.py:1455-1482)."""

    @staticmethod
    def forward(ctx, h, src_sorted, rowptr):
        ctx.save_for_backward(src_sorted, rowptr)
        return _atom_gather_forward(atom_neighbor_sum_sorted, h, None,
                                    src_sorted, rowptr)

    @staticmethod
    def backward(ctx, g):
        src_sorted, rowptr = ctx.saved_tensors
        return _atom_gather_forward(atom_neighbor_sum_sorted, g.contiguous(),
                                    None, src_sorted, rowptr), None, None


class _SrcReadoutFn(torch.autograd.Function):
    """``a[v] = sum_{c: dst c = v} w[c] h[src c]`` with the VJP of
    pallas_mpnn.py ``_src_readout_op``: since ``src c = dst(srev c)``,
    ``dh[u] = sum_{c': dst c' = u} w[srev c'] g[src c']``, the same kernel
    with the weights read through ``srev``."""

    @staticmethod
    def forward(ctx, h, w_sorted, src_sorted, srev, rowptr):
        ctx.save_for_backward(w_sorted, src_sorted, srev, rowptr)
        return _atom_gather_forward(src_readout_sorted, h, w_sorted,
                                    src_sorted, rowptr)

    @staticmethod
    def backward(ctx, g):
        w_sorted, src_sorted, srev, rowptr = ctx.saved_tensors
        dh = _atom_gather_forward(src_readout_sorted, g.contiguous(),
                                  w_sorted, src_sorted, rowptr, widx=srev)
        return dh, None, None, None, None


class _BandAggFn(torch.autograd.Function):
    """``z = S m - m`` with the VJP of ``_band_op``: ``dm = band_bwd(g)``."""

    @staticmethod
    def forward(ctx, m, w_sorted, rowptr):
        ctx.save_for_backward(w_sorted, rowptr)
        return _band_agg_forward(m, w_sorted, rowptr)

    @staticmethod
    def backward(ctx, g):
        w_sorted, rowptr = ctx.saved_tensors
        return band_bwd(g.contiguous(), w_sorted, rowptr), None, None


def _band_matmul_vjp(g_pre, z, wh, w_sorted, rowptr, need_m, need_wh):
    """``(dm, dW_h)`` of ``z @ W_h`` with ``z = S m - m`` for the cotangent
    ``g_pre`` of the product: ``dW_h = z^T g_pre``,
    ``dm = band_bwd(g_pre @ W_h^T)``."""
    dwh = z.t() @ g_pre if need_wh else None
    dm = None
    if need_m:
        dm = band_bwd((g_pre @ wh.t()).contiguous(), w_sorted, rowptr)
    return dm, dwh


class _BandMatmulActFn(torch.autograd.Function):
    """``act(inp_srev + (S m - m) @ W_h)`` with the VJP of
    band_matmul_act_step_sorted: ``z`` is written only when a gradient is
    wanted, and the activation's derivative is taken from the output."""

    @staticmethod
    def forward(ctx, m, wh, inp_srev, w_sorted, rowptr, act, precision):
        want_z = any(ctx.needs_input_grad[:3])
        out, z = band_matmul_act_forward(m, inp_srev, wh, w_sorted, rowptr,
                                         act, want_z, precision)
        if want_z:
            ctx.save_for_backward(z, wh, out, w_sorted, rowptr)
            ctx.act = act.lower()
        return out

    @staticmethod
    def backward(ctx, g):
        z, wh, out, w_sorted, rowptr = ctx.saved_tensors
        need_m, need_wh, need_inp = ctx.needs_input_grad[:3]
        g_pre = g * act_grad_from_output(ctx.act, out)
        dm, dwh = _band_matmul_vjp(g_pre, z, wh, w_sorted, rowptr, need_m,
                                   need_wh)
        return dm, dwh, g_pre if need_inp else None, None, None, None, None


class _BandMatmulFn(torch.autograd.Function):
    """``(S m - m) @ W_h`` with the VJP of band_matmul_step_sorted."""

    @staticmethod
    def forward(ctx, m, wh, w_sorted, rowptr, precision):
        out, z = band_matmul_forward(m, wh, w_sorted, rowptr, precision)
        ctx.save_for_backward(z, wh, w_sorted, rowptr)
        return out

    @staticmethod
    def backward(ctx, g):
        z, wh, w_sorted, rowptr = ctx.saved_tensors
        need_m, need_wh = ctx.needs_input_grad[:2]
        dm, dwh = _band_matmul_vjp(g, z, wh, w_sorted, rowptr, need_m,
                                   need_wh)
        return dm, dwh, None, None, None


class _PermuteRowsFn(torch.autograd.Function):
    """``x[idx]`` for a permutation ``idx`` with inverse ``inv_idx``; the
    backward is the gather ``g[inv_idx]``, never a scatter."""

    @staticmethod
    def forward(ctx, x, idx, inv_idx):
        ctx.save_for_backward(inv_idx)
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        inv_idx, = ctx.saved_tensors
        return g.index_select(0, inv_idx), None, None


def band_rev_layer(m: torch.Tensor, inp: torch.Tensor, wh: torch.Tensor,
                   w_sorted: torch.Tensor, src_sorted: torch.Tensor,
                   srev: torch.Tensor, rowptr: torch.Tensor,
                   act: str, precision: str = "highest") -> torch.Tensor:
    """One rev-fused wD-MPNN layer over dst-sorted bonds, the product at
    ``precision`` (module docstring).

    m, inp: (B, H) f32; wh: (H, H) f32 in (in, out) layout; w_sorted: (B,)
    f32; src_sorted, srev: (B,) int32; rowptr: (A + 1,) int32."""
    return _BandRevLayerFn.apply(m, wh, inp, w_sorted, src_sorted, srev,
                                 rowptr, act, precision)


def atom_readout(m: torch.Tensor, w_sorted: torch.Tensor,
                 rowptr: torch.Tensor,
                 dst_sorted: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted incoming-bond sum per atom: (B, H) -> (A, H).

    ``dst_sorted`` (B,), the destination atom of every sorted bond (0 on
    padding rows), is read only by the gradient; without it, it is rebuilt
    from ``rowptr``."""
    if dst_sorted is None:
        if not (torch.is_grad_enabled() and m.requires_grad):
            return _atom_readout_forward(m, w_sorted, rowptr)
        dst_sorted = dst_from_rowptr(rowptr, m.shape[0])
    return _AtomReadoutFn.apply(m, w_sorted, rowptr, dst_sorted)


def permute_rows(x: torch.Tensor, idx: torch.Tensor,
                 inv_idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a row permutation ``idx`` (int32 or int64) with
    inverse ``inv_idx``; differentiable by the gather ``g[inv_idx]``
    (pallas_mpnn.py permute_rows). ``srev`` is its own inverse."""
    return _PermuteRowsFn.apply(x, idx, inv_idx)


def band_agg(m: torch.Tensor, w_sorted: torch.Tensor,
             rowptr: torch.Tensor) -> torch.Tensor:
    """The plain band aggregation over dst-sorted bonds, ``z = S m - m``:
    each row gets its destination atom's weighted incoming sum minus
    itself; padding rows get ``-m``.

    m: (B, H) f32; w_sorted: (B,) f32; rowptr: (A + 1,) int32."""
    return _BandAggFn.apply(m, w_sorted, rowptr)


def band_matmul_act(m: torch.Tensor, inp_srev: torch.Tensor,
                    wh: torch.Tensor, w_sorted: torch.Tensor,
                    rowptr: torch.Tensor, act: str,
                    precision: str = "highest") -> torch.Tensor:
    """``act(inp_srev + (S m - m) @ W_h)``: the plain band aggregation with
    the update product, the residual and the activation in one kernel, the
    product at ``precision`` (module docstring).

    m, inp_srev: (B, H) f32; wh: (H, H) f32 in (in, out) layout; w_sorted:
    (B,) f32; rowptr: (A + 1,) int32."""
    return _BandMatmulActFn.apply(m, wh, inp_srev, w_sorted, rowptr, act,
                                  precision)


def band_matmul(m: torch.Tensor, wh: torch.Tensor, w_sorted: torch.Tensor,
                rowptr: torch.Tensor, precision: str = "highest"
                ) -> torch.Tensor:
    """``(S m - m) @ W_h``: the plain band aggregation with the update
    product in one kernel, no residual and no activation. Shapes and
    ``precision`` as for :func:`band_matmul_act`."""
    return _BandMatmulFn.apply(m, wh, w_sorted, rowptr, precision)


def band_message_step_sorted(m: torch.Tensor,
                             aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """New message in sorted order, ``(S m - m)[srev]``: :func:`band_agg`
    then the reverse-bond gather. ``aux`` holds the batch's ``w_sorted``,
    ``rowptr`` and ``srev`` tensors (:mod:`.sorted_aux`)."""
    z = band_agg(m, aux["w_sorted"], aux["rowptr"])
    return permute_rows(z, aux["srev"], aux["srev"])


def band_matmul_step_sorted(m: torch.Tensor, wh: torch.Tensor,
                            aux: Dict[str, torch.Tensor],
                            precision: str = "highest") -> torch.Tensor:
    """``((S m - m) @ W_h)[srev]``: :func:`band_matmul` then the
    reverse-bond gather."""
    out = band_matmul(m, wh, aux["w_sorted"], aux["rowptr"], precision)
    return permute_rows(out, aux["srev"], aux["srev"])


def band_matmul_act_step_sorted(m: torch.Tensor, wh: torch.Tensor,
                                inp_srev: torch.Tensor,
                                aux: Dict[str, torch.Tensor],
                                act: str, precision: str = "highest"
                                ) -> torch.Tensor:
    """One whole layer, ``act(inputs + ((S m - m) @ W_h)[srev])``, computed
    as ``act(inp_srev + (S m - m) @ W_h)[srev]`` (``srev`` is an
    involution): :func:`band_matmul_act` on the residual pre-permuted by
    ``srev``, then the reverse-bond gather."""
    out = band_matmul_act(m, inp_srev, wh, aux["w_sorted"], aux["rowptr"],
                          act, precision)
    return permute_rows(out, aux["srev"], aux["srev"])


def bond_message_step_natural(m: torch.Tensor,
                              aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """:func:`band_message_step_sorted` on messages in natural bond order:
    the drop-in for :func:`..ops.segment.bond_message_step` and the
    counterpart of pallas_mpnn.py ``bond_message_step_pallas``. The rows
    are permuted into dst-sorted order by ``aux["perm"]`` and back by its
    inverse. Real rows equal ``bond_message_step``'s; a padding row comes
    out as minus its own message (there: minus bond 0's)."""
    perm = aux["perm"]
    rank = torch.empty_like(perm)
    rank[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                     device=perm.device)
    out = band_message_step_sorted(permute_rows(m, perm, rank), aux)
    return permute_rows(out, rank, perm)


def atom_neighbor_sum_sorted(h: torch.Tensor,
                             aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The unweighted neighbour sum over atoms, counting bond multiplicity:
    ``out[v] = sum_{c in run(v)} h[src c]``, (A, H) -> (A, H), for the
    ``atom_messages`` layer (pallas_mpnn.py:1485). ``aux`` holds the
    batch's ``src_sorted`` and ``rowptr`` (:mod:`.sorted_aux`); h f32.
    Atom 0 (padding) has an empty run and reads 0."""
    return _AtomNeighborSumFn.apply(h, aux["src_sorted"], aux["rowptr"])


def src_readout_sorted(h: torch.Tensor,
                       aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The ``atom_messages`` readout, each incoming bond weighted by its own
    weight: ``a[v] = sum_{c in run(v)} w[c] h[src c]``, (A, H) -> (A, H)
    (pallas_mpnn.py:1528). ``aux`` holds ``w_sorted``, ``src_sorted``,
    ``srev`` (read by the gradient) and ``rowptr``."""
    return _SrcReadoutFn.apply(h, aux["w_sorted"], aux["src_sorted"],
                               aux["srev"], aux["rowptr"])


def csr_gather_sum(h: torch.Tensor, idx: torch.Tensor,
                   w: Optional[torch.Tensor],
                   rowptr: torch.Tensor) -> torch.Tensor:
    """``out[v] = sum_{c in run(v)} w[c] h[idx[c]]`` over any row table
    ``h`` (``w`` None: unit weights), forward only: the gather entry of
    csrc/atom_readout.cu, counted with sub-row 3a
    (``atom_neighbor_sum_sorted.launches``) at unit weights and 3b
    (``src_readout_sorted.launches``) otherwise. The edge-partitioned
    encoder (parallel/partition.py) builds its gather VJP on it. idx: (B,)
    int32 rows of ``h``; w: (B,) f32 or None; rowptr: (A + 1,) int32."""
    wrapper = atom_neighbor_sum_sorted if w is None else src_readout_sorted
    return _atom_gather_forward(wrapper, h.contiguous(), w, idx, rowptr,
                                rows=h.shape[0])


class _MolReadoutFn(torch.autograd.Function):
    """``out[m] = aggregate(sum_{r in run(m)} w[r] h[r])`` over a molecule
    CSR (``mol_idx``, ``mol_rowptr``) in one launch of
    ``molecule_readout_f32`` (:func:`molecule_readout_plain` on CPU
    tensors), the weights read from ``w`` (A,) through the CSR's index at
    call time; with ``aggregation`` None the sum alone, one launch of the
    gather entry with the weight index ``idx``. Either launch is counted
    in ``molecule_readout_sorted.launches``. The VJP is the one
    autograd takes through :func:`aggregate_molecules` (``g * dop``; for
    ``mean`` ``where(denom > 0, ., 0)`` then the division by
    ``clamp(denom, 1e-12)``, for ``norm`` the division by the scalar), then
    the row gather ``w[r] g'[a2mol r]``, which gives 0 to every row of
    weight 0 and so to every row outside the CSR."""

    @staticmethod
    def forward(ctx, h, w, a2mol, idx, rowptr, denom, degree_of_polym,
                aggregation, aggregation_norm):
        ctx.save_for_backward(w, a2mol, denom, degree_of_polym)
        ctx.aggregation, ctx.aggregation_norm = aggregation, aggregation_norm
        if h.device.type == "cpu":
            return molecule_readout_plain(h, w, idx, rowptr, denom,
                                          degree_of_polym, aggregation,
                                          aggregation_norm)
        if aggregation is None:
            # the sum alone: the gather entry, its weights read through idx
            out = _atom_gather_launch("molecule_sum", h, idx, w, rowptr,
                                      rows=h.shape[0], widx=idx)
        else:
            out = _molecule_readout_launch(h, w, idx, rowptr, denom,
                                           degree_of_polym, aggregation,
                                           aggregation_norm)
        molecule_readout_sorted.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        w, a2mol, denom, degree_of_polym = ctx.saved_tensors
        if ctx.aggregation is not None:
            g = g * degree_of_polym[:, None]
            if ctx.aggregation == "mean":
                g = torch.where(denom[:, None] > 0, g, 0)
                g = g / torch.clamp(denom, min=1e-12)[:, None]
            elif ctx.aggregation == "norm":
                g = g / ctx.aggregation_norm
        return (w[:, None] * g[a2mol.long()], None, None, None, None, None,
                None, None, None)


def molecule_sum(h: torch.Tensor, w: torch.Tensor, a2mol: torch.Tensor,
                 idx: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """The weighted atom sum of each molecule, ``(A, H) -> (M, H)``, in the
    CSR's row order (:class:`_MolReadoutFn` with no aggregation). h (A, H)
    f32; w (A,) f32; a2mol (A,) int; idx int32 rows of ``h``; rowptr
    (M + 1,) int32."""
    return _MolReadoutFn.apply(h, w, a2mol, idx, rowptr, None, None, None,
                               100.0)


def aggregate_molecules(wsum: torch.Tensor, denom: torch.Tensor,
                        degree_of_polym: torch.Tensor,
                        aggregation: str = "mean",
                        aggregation_norm: float = 100.0) -> torch.Tensor:
    """The readout's aggregation of the weighted sums ``wsum`` (M, H)
    (reference mpn.py:145-171): ``mean`` divides by the weight sums
    ``denom`` (M,) (a molecule with none reads 0), ``sum`` keeps them,
    ``norm`` divides by ``aggregation_norm``; then each row is scaled by
    the degree of polymerization, ``1 + log10(Xn)``."""
    if aggregation == "mean":
        out = wsum / torch.clamp(denom, min=1e-12)[:, None]
        out = torch.where(denom[:, None] > 0, out, torch.zeros_like(out))
    elif aggregation == "sum":
        out = wsum
    elif aggregation == "norm":
        out = wsum / aggregation_norm
    else:
        raise ValueError(f"unknown aggregation {aggregation!r}")
    return out * degree_of_polym[:, None]


def molecule_readout_sorted(h: torch.Tensor, w: torch.Tensor,
                            a2mol: torch.Tensor,
                            aux: Dict[str, torch.Tensor],
                            degree_of_polym: torch.Tensor,
                            aggregation: str = "mean",
                            aggregation_norm: float = 100.0) -> torch.Tensor:
    """The molecule readout of ``ops/segment.py`` ``molecule_readout``
    with every sum in a fixed order: the weighted sum over the batch's
    molecule CSR (``aux``'s ``mol_idx`` and ``mol_rowptr``), the ``mean``
    denominator ``aux["mol_denom"]`` summed on the host in the same order,
    then :func:`aggregate_molecules`, bit for bit. On CPU tensors that
    composition (:func:`molecule_readout_plain`); on CUDA tensors one
    launch of ``molecule_readout_f32``, counted in
    ``molecule_readout_sorted.launches``."""
    if aggregation not in ("mean", "sum", "norm"):
        raise ValueError(f"unknown aggregation {aggregation!r}")
    return _MolReadoutFn.apply(h, w, a2mol, aux["mol_idx"],
                               aux["mol_rowptr"], aux["mol_denom"],
                               degree_of_polym.contiguous(), aggregation,
                               aggregation_norm)


WRAPPERS = (band_rev_layer, band_rev_bwd, atom_readout, band_agg, band_bwd,
            band_matmul_act, band_matmul, atom_neighbor_sum_sorted,
            src_readout_sorted, molecule_readout_sorted)
TC_WRAPPERS = (band_rev_layer, band_matmul_act, band_matmul)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in TC_WRAPPERS:
        fn.tc_launches = 0


reset_launch_counts()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def tc_launch_counts() -> dict:
    """Of :func:`launch_counts`, the launches that ran the tensor-core
    stage (``band_precision`` ``"high"`` or ``"default"``)."""
    return {fn.__name__: fn.tc_launches for fn in TC_WRAPPERS}
