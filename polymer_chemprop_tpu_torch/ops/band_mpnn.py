"""The encoder's two message-passing kernels: wrappers and plain versions.

* :func:`band_rev_layer`: one whole depth-loop layer over dst-sorted bonds,
  ``out = act(inp + z @ W_h)`` with
  ``z[t] = sum_{c in run(src t)} w[c] m[c] - m[srev t]``
  (csrc/band_rev_layer.cu; replaces the JAX package's
  ``_band_rev_act_kernel``).
* :func:`atom_readout`: ``a[v] = sum_{c in run(v)} w[c] m[c]``
  (csrc/atom_readout.cu; replaces ``_atom_band_kernel``).

``run(v)`` is the CSR run ``[rowptr[v], rowptr[v + 1])`` of
:mod:`.sorted_aux`. A wrapper given CPU tensors computes the plain PyTorch
version beside it; given CUDA tensors it launches its kernel on the current
stream or raises. There is no fallback from one to the other. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ..models.nn import get_activation

# activation ids shared with the CUDA epilogue (csrc/band_rev_layer.cu)
ACT_IDS = {"relu": 0, "leakyrelu": 1, "prelu": 2, "tanh": 3, "elu": 4,
           "selu": 5}


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


def band_rev_layer_plain(m: torch.Tensor, inp: torch.Tensor,
                         wh: torch.Tensor, w_sorted: torch.Tensor,
                         src_sorted: torch.Tensor, srev: torch.Tensor,
                         rowptr: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version of :func:`band_rev_layer`."""
    a = atom_readout_plain(m, w_sorted, rowptr)
    z = a[src_sorted.long()] - m[srev.long()]
    return get_activation(act)(inp + z @ wh)


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


def band_rev_layer(m: torch.Tensor, inp: torch.Tensor, wh: torch.Tensor,
                   w_sorted: torch.Tensor, src_sorted: torch.Tensor,
                   srev: torch.Tensor, rowptr: torch.Tensor,
                   act: str) -> torch.Tensor:
    """One rev-fused wD-MPNN layer over dst-sorted bonds.

    m, inp: (B, H) f32; wh: (H, H) f32 in (in, out) layout; w_sorted: (B,)
    f32; src_sorted, srev: (B,) int32; rowptr: (A + 1,) int32."""
    act = act.lower()
    if act not in ACT_IDS:
        raise ValueError(f'Activation "{act}" not supported.')
    if m.device.type == "cpu":
        return band_rev_layer_plain(m, inp, wh, w_sorted, src_sorted, srev,
                                    rowptr, act)
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.band_rev_layer_f32(
            m.data_ptr(), inp.data_ptr(), wh.data_ptr(), w_sorted.data_ptr(),
            src_sorted.data_ptr(), srev.data_ptr(), rowptr.data_ptr(),
            out.data_ptr(), None, B, H, ACT_IDS[act], stream)
    _raise_on(err, "band_rev_layer")
    band_rev_layer.launches += 1
    return out


def atom_readout(m: torch.Tensor, w_sorted: torch.Tensor,
                 rowptr: torch.Tensor) -> torch.Tensor:
    """Weighted incoming-bond sum per atom: (B, H) -> (A, H)."""
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


band_rev_layer.launches = 0
atom_readout.launches = 0
WRAPPERS = (band_rev_layer, atom_readout)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
