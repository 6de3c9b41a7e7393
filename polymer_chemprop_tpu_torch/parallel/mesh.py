"""Rank meshes and the collectives the parallel modules use.

The port's counterpart of polymer_chemprop_tpu parallel/mesh.py. The JAX
package lays its devices out as a ``jax.sharding.Mesh`` with named axes;
here every rank is one process (started by ``torchrun``), and a
:class:`Mesh` lays the ranks of the default process group out the same
way, row-major: ``make_mesh(4, ("dp", "ep"), shape=(2, 2))`` puts ranks 0
and 1 in the first dp row and ranks 0 and 2 in the first ep column, as
``Mesh(devices.reshape((2, 2)))`` does with devices. Each named axis gets
one ``torch.distributed`` process group per line of the grid, and each
rank keeps its coordinates, the group of its own line along every axis and
its neighbours there.

Without a process group (one process) the mesh has one rank and every
collective below is the identity, so the single-rank forms of the
parallel functions run in any process.

Transport. gloo moves host tensors only (it has no point-to-point for
CUDA tensors), so when the backend of a group is gloo and a tensor lives
on a card, the collective stages it through pinned host memory and copies
the result back; the kernels on either side still run on the card. This
is how two ranks that share one GPU talk (NCCL refuses two ranks on one
device). NCCL moves CUDA tensors directly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A grid of ranks with named axes (module docstring).

    ``devices``: the ranks as an integer array of the mesh's shape;
    ``shape``: ``{axis: size}``; ``coords``: this rank's ``{axis: index}``
    (None when this rank is not in the mesh). Building one creates the
    process groups of every line, so every rank of the default group must
    build the same meshes in the same order, as ``dist.new_group``
    requires."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {ranks.shape} needs "
                             f"{ranks.ndim} axis names, got {axis_names}")
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        self.rank, size = world()
        pos = np.argwhere(ranks == self.rank)
        self.coords: Optional[Dict[str, int]] = (
            {a: int(i) for a, i in zip(self.axis_names, pos[0])}
            if pos.size else None)
        self._lines: Dict[str, List[int]] = {}
        self._groups: Dict[str, object] = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for line in lines.tolist():
                group = _new_group(line, size)
                if self.rank in line:
                    self._lines[name] = line
                    self._groups[name] = group
        self._all_group = _new_group(ranks.reshape(-1).tolist(), size)

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: Optional[str] = None):
        """Process group of this rank's line along ``axis`` (all the mesh's
        ranks for None); None when that line is this rank alone."""
        return self._all_group if axis is None else self._groups[axis]

    def peer(self, axis: str, delta: int) -> Optional[int]:
        """Global rank ``delta`` steps along ``axis``, or None past either
        end (no wraparound, as the JAX package's ``ppermute`` pairs)."""
        line = self._lines[axis]
        i = line.index(self.rank) + delta
        return line[i] if 0 <= i < len(line) else None


def _new_group(ranks: List[int], world_size: int):
    """A process group over ``ranks``; None for a single rank. Called by
    every rank for every group (``dist.new_group``'s contract)."""
    if world_size <= 1 or len(ranks) <= 1:
        return None
    if len(ranks) == world_size and ranks == list(range(world_size)):
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks by default; pass
    ``shape`` for several axes (``make_mesh(8, ("dp", "ep"),
    shape=(2, 4))``). Ranks past ``n_devices`` are outside the mesh
    (``coords`` None). JAX parallel/mesh.py:20-39."""
    _, size = world()
    n = n_devices or size
    if n > size:
        raise ValueError(f"requested {n} devices, have {size}")
    ranks = np.arange(n)
    if shape is not None:
        if int(np.prod(shape)) != n:
            raise ValueError(f"mesh shape {tuple(shape)} does not use "
                             f"{n} devices")
        return Mesh(ranks.reshape(tuple(shape)), axis_names)
    mshape = [1] * len(axis_names)
    mshape[0] = n
    return Mesh(ranks.reshape(mshape), axis_names)


# -- collectives ----------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` as a new tensor on ``t``'s device
    (``t`` itself for a single-rank group)."""
    if group is None:
        return t
    if _staged(t, group):
        host = _to_host(t)
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """``t`` of every rank of ``group``, in rank order, on ``t``'s
    device."""
    if group is None:
        return [t]
    n = dist.get_world_size(group)
    if _staged(t, group):
        host = _to_host(t)
        outs = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(outs, host, group=group)
        return [o.to(t.device) for o in outs]
    outs = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(outs, t.contiguous(), group=group)
    return outs


class PendingExchange:
    """A posted neighbour exchange along one mesh axis (:func:`exchange`);
    :meth:`wait` returns ``(from_prev, from_next)`` on the device of the
    tensors sent, zeros where there is no neighbour, as a ``ppermute``
    with a missing source delivers."""

    def __init__(self, reqs, recv, like_prev, like_next, device, ops):
        self._reqs, self._recv = reqs, recv
        self._ops = ops      # holds the (host) tensors until the sends end
        self._like = (like_prev, like_next)
        self._device = device

    def wait(self) -> Tuple[torch.Tensor, torch.Tensor]:
        for r in self._reqs:
            r.wait()
        out = []
        for buf, like in zip(self._recv, self._like):
            out.append(torch.zeros_like(like) if buf is None
                       else buf.to(self._device))
        return out[0], out[1]


def exchange(mesh: Mesh, axis: str, to_prev: torch.Tensor,
             to_next: torch.Tensor) -> PendingExchange:
    """Post ``to_prev`` to the previous rank along ``axis`` and ``to_next``
    to the next, and the receives of what they send this rank: the
    previous rank's ``to_next`` and the next rank's ``to_prev``, each of
    the shape of this rank's tensor of the same name. One
    ``dist.batch_isend_irecv``; returns at once."""
    group = mesh.group(axis)
    prev, nxt = mesh.peer(axis, -1), mesh.peer(axis, +1)
    staged = group is not None and _staged(to_prev, group)
    ops, recv = [], [None, None]
    for peer, send, slot, like in ((prev, to_prev, 0, to_next),
                                   (nxt, to_next, 1, to_prev)):
        if peer is None:
            continue
        send = _to_host(send) if staged else send.contiguous()
        buf = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
               if staged else torch.empty_like(like))
        ops.append(dist.P2POp(dist.isend, send, peer, group))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        recv[slot] = buf
    reqs = dist.batch_isend_irecv(ops) if ops else []
    return PendingExchange(reqs, recv, to_next, to_prev, to_prev.device, ops)
