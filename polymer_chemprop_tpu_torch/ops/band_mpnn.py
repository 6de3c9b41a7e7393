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

``run(v)`` is the CSR run ``[rowptr[v], rowptr[v + 1])`` of
:mod:`.sorted_aux`. A wrapper given CPU tensors computes the plain PyTorch
version beside it; given CUDA tensors it launches its kernel on the current
stream or raises. There is no fallback from one to the other. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

The gradients are hand-written ``torch.autograd.Function``s that mirror the
JAX package's ``custom_vjp``s (pallas_mpnn.py:1251-1274, 1378-1395) and run
the same formulas on both devices: on CPU tensors only the kernels are
replaced by their plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.nn import get_activation

# activation ids shared with the CUDA epilogue (csrc/band_rev_layer.cu)
ACT_IDS = {"relu": 0, "leakyrelu": 1, "prelu": 2, "tanh": 3, "elu": 4,
           "selu": 5}
_SELU_L = 1.0507009873554805
_SELU_AL = 1.6732632423543772 * _SELU_L


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


def atom_readout_plain(m: torch.Tensor, w_sorted: torch.Tensor,
                       rowptr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`atom_readout`, with ``index_add_``."""
    A = rowptr.shape[0] - 1
    n = int(rowptr[-1])
    out = m.new_zeros((A, m.shape[1]))
    return out.index_add_(0, _csr_rows(rowptr), m[:n] * w_sorted[:n, None])


def band_rev_z_plain(m: torch.Tensor, w_sorted: torch.Tensor,
                     src_sorted: torch.Tensor, srev: torch.Tensor,
                     rowptr: torch.Tensor) -> torch.Tensor:
    """``z = M m``: the aggregation inside :func:`band_rev_layer`."""
    a = atom_readout_plain(m, w_sorted, rowptr)
    return a[src_sorted.long()] - m[srev.long()]


def band_rev_layer_plain(m: torch.Tensor, inp: torch.Tensor,
                         wh: torch.Tensor, w_sorted: torch.Tensor,
                         src_sorted: torch.Tensor, srev: torch.Tensor,
                         rowptr: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version of :func:`band_rev_layer`."""
    z = band_rev_z_plain(m, w_sorted, src_sorted, srev, rowptr)
    return get_activation(act)(inp + z @ wh)


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


def band_rev_layer_forward(m: torch.Tensor, inp: torch.Tensor,
                           wh: torch.Tensor, w_sorted: torch.Tensor,
                           src_sorted: torch.Tensor, srev: torch.Tensor,
                           rowptr: torch.Tensor, act: str, want_z: bool
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer without autograd: ``(out, z)`` with ``z = M m`` written
    only when ``want_z`` (training), else ``(out, None)``."""
    act = act.lower()
    if act not in ACT_IDS:
        raise ValueError(f'Activation "{act}" not supported.')
    if m.device.type == "cpu":
        z = band_rev_z_plain(m, w_sorted, src_sorted, srev, rowptr)
        return get_activation(act)(inp + z @ wh), (z if want_z else None)
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
    from ..kernels.build import load
    lib = load("band_rev_layer")
    if lib.band_rev_layer_smem_bytes(H) > 227 * 1024:
        raise NotImplementedError(
            f"band_rev_layer: hidden size {H} needs more shared memory than "
            "a block has; wide layers need a column-chunked kernel")
    out = torch.empty_like(m)
    z = torch.empty_like(m) if want_z else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.band_rev_layer_f32(
            m.data_ptr(), inp.data_ptr(), wh.data_ptr(), w_sorted.data_ptr(),
            src_sorted.data_ptr(), srev.data_ptr(), rowptr.data_ptr(),
            out.data_ptr(), z.data_ptr() if want_z else None, B, H,
            ACT_IDS[act], stream)
    _raise_on(err, "band_rev_layer")
    band_rev_layer.launches += 1
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


# -- autograd ----------------------------------------------------------------

class _BandRevLayerFn(torch.autograd.Function):
    """``act(inp + (M m) @ W_h)`` with the VJP of
    band_rev_layer_step_sorted: ``z`` is written only when a gradient is
    wanted, and the backward needs no pre-activation (the activation's
    derivative is taken from its output)."""

    @staticmethod
    def forward(ctx, m, wh, inp, w_sorted, src_sorted, srev, rowptr, act):
        want_z = any(ctx.needs_input_grad[:3])
        out, z = band_rev_layer_forward(m, inp, wh, w_sorted, src_sorted,
                                        srev, rowptr, act, want_z)
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
                None, None, None, None, None)


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


def band_rev_layer(m: torch.Tensor, inp: torch.Tensor, wh: torch.Tensor,
                   w_sorted: torch.Tensor, src_sorted: torch.Tensor,
                   srev: torch.Tensor, rowptr: torch.Tensor,
                   act: str) -> torch.Tensor:
    """One rev-fused wD-MPNN layer over dst-sorted bonds.

    m, inp: (B, H) f32; wh: (H, H) f32 in (in, out) layout; w_sorted: (B,)
    f32; src_sorted, srev: (B,) int32; rowptr: (A + 1,) int32."""
    return _BandRevLayerFn.apply(m, wh, inp, w_sorted, src_sorted, srev,
                                 rowptr, act)


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
        rows = _csr_rows(rowptr)
        dst_sorted = rows.new_zeros(m.shape[0])
        dst_sorted[:rows.shape[0]] = rows
    return _AtomReadoutFn.apply(m, w_sorted, rowptr, dst_sorted)


band_rev_layer.launches = 0
band_rev_bwd.launches = 0
atom_readout.launches = 0
WRAPPERS = (band_rev_layer, band_rev_bwd, atom_readout)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
