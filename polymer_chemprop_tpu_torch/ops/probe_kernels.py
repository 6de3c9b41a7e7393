"""The probes' two kernels: wrappers, plain versions, and their operands.

* :func:`band_ctrl`: the band-layer control (csrc/band_ctrl.cu; replaces
  scripts/band_mxu_probe.py ``_ctrl_kernel``). For every row ``t`` of the
  32-row block ``j = t // 32``,
  ``z[t] = sum_{c in [lo[j], hi[j])} w[c] m[c]``, and then
  ``out = relu(inp + z @ W_h)`` (``mode="noq"``) or ``out = z @ W_h``
  (``mode="pure"``), as the TPU control computes them. Its grid, shared
  memory and product stage are :func:`~.band_mpnn.band_rev_layer`'s, so
  the two times differ by the layer's CSR z build alone.
  :func:`own_row_ranges` gives each block its own rows;
  :func:`window_ranges` the TPU control's 512-row windows, with which it
  computes ``_ctrl_apply``.
* :func:`fused_matmul`: ``x_hi @ b_hi + x_hi @ b_lo + x_lo @ b_hi`` on the
  tensor cores, x split into bf16 halves as the kernel stages it
  (csrc/fused_matmul.cu, ``wgmma`` on the machinery of
  csrc/band_tile_sm90.cuh; replaces scripts/fused_matmul_probe.py
  ``_fused_kernel``); :func:`split_bf16` (from :mod:`.band_mpnn`) splits
  the weight once, and the wrapper packs both halves into a scratch of
  :func:`fused_matmul_scratch_bytes` per call.

As in :mod:`.band_mpnn`, a wrapper given CPU tensors computes the plain
PyTorch version beside it; given CUDA tensors it launches its kernel on the
current stream or raises. Each wrapper counts its kernel launches in
``<wrapper>.launches``. Neither is on the serving or training path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .band_mpnn import (  # noqa: F401 (split_bf16 is part of this API)
    _TC_KC,
    _TC_NP,
    _TC_SLICE_BYTES,
    _check,
    _check_fits,
    _raise_on,
    float32_matmul_precision,
    split_bf16,
)

BLOCK_ROWS = 32              # band_tile::ROWS: rows per block of band_ctrl
MODES = {"noq": 0, "pure": 1}
# the TPU control's geometry (pallas_mpnn.py TILE_B and _EXT_FOR[TILE_B]):
# rows per tile and the window each tile reads
TPU_TILE, TPU_WINDOW = 256, 512


# -- operands ----------------------------------------------------------------

def own_row_ranges(B: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` with each 32-row block's range its own rows,
    ``[32 j, min(32 j + 32, B))``: the control with the layer's reads and
    no data-dependent loop."""
    lo = torch.arange(0, B, BLOCK_ROWS, dtype=torch.int32, device=device)
    return lo, torch.clamp(lo + BLOCK_ROWS, max=B)


def window_ranges(starts: np.ndarray, B: int, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` of the TPU control: the 32-row block ``j`` lies in TPU
    tile ``32 j // TPU_TILE``, whose window is
    ``[starts[tile], starts[tile] + TPU_WINDOW)`` (the JAX package's
    ``rs_rev`` gives the TPU's own starts)."""
    tiles = np.arange(0, B, BLOCK_ROWS) // TPU_TILE
    lo = np.asarray(starts, np.int64)[tiles]
    return (torch.as_tensor(lo.astype(np.int32), device=device),
            torch.as_tensor((lo + TPU_WINDOW).astype(np.int32),
                            device=device))


def fused_matmul_scratch_bytes(K: int, M: int) -> int:
    """Bytes of the packed ``(b_hi, b_lo)`` that :func:`fused_matmul`
    takes at (K, M): one slice of the tensor-core stage per (column pass,
    depth chunk) (csrc/fused_matmul.cu ``scratch_bytes``)."""
    return (-(-M // _TC_NP)) * (-(-K // _TC_KC)) * _TC_SLICE_BYTES


# -- plain versions ----------------------------------------------------------

def band_ctrl_z_plain(m: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> torch.Tensor:
    """``z`` of :func:`band_ctrl`, one row per bond row: each distinct range
    is summed once with ``index_add_``."""
    B, H = m.shape
    lo = lo.long().clamp(0, B)
    hi = torch.maximum(hi.long().clamp(0, B), lo)
    ranges, block_range = torch.unique(torch.stack([lo, hi], 1), dim=0,
                                       return_inverse=True)
    lens = ranges[:, 1] - ranges[:, 0]
    seg = torch.repeat_interleave(
        torch.arange(ranges.shape[0], device=m.device), lens)
    rows = (torch.arange(int(lens.sum()), device=m.device)
            - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
            + torch.repeat_interleave(ranges[:, 0], lens))
    z_range = m.new_zeros((ranges.shape[0], H)).index_add_(
        0, seg, m[rows] * w[rows, None])
    return z_range[block_range].repeat_interleave(BLOCK_ROWS, 0)[:B]


def band_ctrl_plain(m: torch.Tensor, inp: Optional[torch.Tensor],
                    wh: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, mode: str = "noq") -> torch.Tensor:
    """Plain version of :func:`band_ctrl`."""
    z = band_ctrl_z_plain(m, w, lo, hi)
    pre = z @ wh
    return pre if mode == "pure" else torch.relu(inp + pre)


def fused_matmul_plain(x: torch.Tensor, b_hi: torch.Tensor,
                       b_lo: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_matmul`: the bf16-rounded operands
    multiplied as float32, TF32 off (a bf16 x bf16 product in PyTorch would
    round its result to bf16)."""
    x_hi, x_lo = (t.float() for t in split_bf16(x))
    bh, bl = b_hi.float(), b_lo.float()
    with float32_matmul_precision("highest"):
        return x_hi @ bh + x_hi @ bl + x_lo @ bh


# -- wrappers ----------------------------------------------------------------

def band_ctrl(m: torch.Tensor, inp: Optional[torch.Tensor], wh: torch.Tensor,
              w: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              mode: str = "noq") -> torch.Tensor:
    """The band-layer control (module docstring).

    m, inp: (B, H) f32 (``inp`` unused and may be None with
    ``mode="pure"``); wh: (H, H) f32; w: (B,) f32; lo, hi: (ceil(B / 32),)
    int32, clamped to ``[0, B)``."""
    if mode not in MODES:
        raise ValueError(f"band_ctrl: mode must be one of {tuple(MODES)}")
    # the kernel's limit holds on both devices, as for the layer form
    _check_fits("band_ctrl", m.shape[-1])
    if m.device.type == "cpu":
        return band_ctrl_plain(m, inp, wh, w, lo, hi, mode)
    if m.device.type != "cuda":
        raise ValueError(f"band_ctrl: unsupported device {m.device}")
    B, H = m.shape
    nblk = -(-B // BLOCK_ROWS)
    dev = m.device
    _check("m", m, (B, H), torch.float32, dev)
    if mode == "noq":
        if inp is None:
            raise ValueError('band_ctrl: mode "noq" needs inp')
        _check("inp", inp, (B, H), torch.float32, dev)
    _check("wh", wh, (H, H), torch.float32, dev)
    _check("w", w, (B,), torch.float32, dev)
    _check("lo", lo, (nblk,), torch.int32, dev)
    _check("hi", hi, (nblk,), torch.int32, dev)
    from ..kernels.build import load
    lib = load("band_ctrl")
    out = torch.empty_like(m)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.band_ctrl_f32(
            m.data_ptr(), inp.data_ptr() if mode == "noq" else None,
            wh.data_ptr(), w.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), B, H, MODES[mode], stream)
    _raise_on(err, "band_ctrl")
    band_ctrl.launches += 1
    return out


def fused_matmul(x: torch.Tensor, b_hi: torch.Tensor,
                 b_lo: torch.Tensor) -> torch.Tensor:
    """``x_hi @ b_hi + x_hi @ b_lo + x_lo @ b_hi`` with float32 accumulation.

    x: (N, K) f32; b_hi, b_lo: (K, M) bf16 (:func:`split_bf16`); returns
    (N, M) f32."""
    if x.device.type == "cpu":
        return fused_matmul_plain(x, b_hi, b_lo)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul: unsupported device {x.device}")
    N, K = x.shape
    M = b_hi.shape[1] if b_hi.dim() == 2 else -1
    dev = x.device
    _check("x", x, (N, K), torch.float32, dev)
    _check("b_hi", b_hi, (K, M), torch.bfloat16, dev)
    _check("b_lo", b_lo, (K, M), torch.bfloat16, dev)
    from ..kernels.build import load
    lib = load("fused_matmul")
    out = x.new_empty((N, M))
    # b_hi and b_lo packed into the stage's swizzled slices, per call
    scratch = torch.empty(fused_matmul_scratch_bytes(K, M),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_matmul_f32(x.data_ptr(), b_hi.data_ptr(),
                                   b_lo.data_ptr(), scratch.data_ptr(),
                                   out.data_ptr(), N, K, M, stream)
    _raise_on(err, "fused_matmul")
    fused_matmul.launches += 1
    return out


WRAPPERS = (band_ctrl, fused_matmul)
for _fn in WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
