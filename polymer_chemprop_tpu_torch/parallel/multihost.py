"""Several processes, several hosts: process groups from torchrun or an
address, the hybrid mesh, host-local input slabs.

The port's counterpart of polymer_chemprop_tpu parallel/multihost.py.

* :func:`initialize_multihost` brings up ``torch.distributed`` (one
  process a rank) from a ``host:port`` or from torchrun's environment,
  with the backend of :func:`pick_backend`, and logs it.
* :func:`make_hybrid_mesh` lays the ranks out with the host-spanning axes
  outermost and the within-host axes innermost, so the halo exchanges of
  an ep line stay inside a host and only the gradient all-reduce crosses
  hosts.
* Every rank runs the same seeded shuffle and featurizes only its slab of
  each global batch (:func:`process_batch_indices`);
  :func:`global_batch_from_local` puts that slab on the rank's device.

The data-parallel step itself is unchanged (dp.py): its flat all-reduce
spans every rank of the axis, within and across hosts.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..train.step import pytree_tensors
from .dp import _tree_map
from .mesh import Mesh, world


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK mod cards>`` for a CUDA
    request (ranks share the cards round robin), else ``device``. Raises
    for CUDA without a GPU, as every entry point of the port does."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def pick_backend(device="cuda") -> str:
    """``"nccl"`` when every rank on this host has a card of its own,
    ``"gloo"`` on the CPU and when ranks share a card (NCCL refuses two
    ranks on one device; gloo's collectives then stage the card's tensors
    through host memory, mesh.py)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if local_world_size() <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _check_nccl(device) -> None:
    """Raise unless NCCL can run here: a CUDA device, and a card of its own
    for every rank of this host. Nothing falls back to gloo."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"backend nccl needs CUDA devices, not {device!r}")
    cards = torch.cuda.device_count()
    if local_world_size() > cards:
        raise ValueError(
            f"backend nccl needs a card for each of the "
            f"{local_world_size()} ranks of this host, which has {cards}: "
            "NCCL refuses two ranks on one device (take gloo)")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device="cuda") -> Optional[str]:
    """Start the default process group (JAX multihost.py:30-41); a no-op
    returning None for one process or when a group is already up.

    Without arguments it reads torchrun's ``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR:MASTER_PORT``; otherwise ``coordinator_address``
    ("host:port", rank 0's), ``num_processes`` and ``process_id`` say it.
    ``backend`` None takes :func:`pick_backend`'s choice. The choice is
    logged and returned; a failure to start raises, nothing falls back:
    NCCL (chosen or asked for) raises unless every rank of the host has a
    card of its own. A CUDA rank first selects its card
    (:func:`rank_device`)."""
    if dist.is_initialized():
        return dist.get_backend()
    n = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return None
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    chosen = backend or pick_backend(device)
    if chosen == "nccl":
        _check_nccl(device)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = f"tcp://{coordinator_address}" if coordinator_address \
        else "env://"
    print(f"torch.distributed: rank {rank} of {n}, backend {chosen} "
          f"({'asked for' if backend else 'by rule'}), device {dev}",
          file=sys.stderr, flush=True)
    # NCCL binds the group to this rank's card: its communicator starts
    # here, and barrier() and the object collectives use this card
    dist.init_process_group(chosen, init_method=init, world_size=n,
                            rank=rank,
                            device_id=dev if chosen == "nccl" else None)
    return chosen


def make_hybrid_mesh(dcn_axes: Dict[str, int],
                     ici_axes: Dict[str, int]) -> Mesh:
    """Mesh with the host-spanning axes (``dcn_axes``, e.g. ``{"dp":
    n_hosts}``) outermost and the within-host axes (``ici_axes``, e.g.
    ``{"ep": ranks_per_host}``) innermost (JAX multihost.py:44-77).
    torchrun numbers ranks host by host, so the row-major layout keeps
    each inner line on one host; the inner size must divide the ranks of
    a host and the product of all sizes be the world size."""
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    inner = int(np.prod(tuple(ici_axes.values())))
    _, size = world()
    if int(np.prod(shape)) != size:
        raise ValueError(f"hybrid mesh {shape} does not use the {size} "
                         f"ranks")
    if inner > 1 and local_world_size() % inner:
        raise ValueError(f"within-host axes of {inner} ranks do not divide "
                         f"the {local_world_size()} ranks of a host")
    return Mesh(np.arange(size).reshape(shape), names)


def process_batch_indices(order: Sequence[int], global_batch_size: int,
                          process_id: Optional[int] = None,
                          num_processes: Optional[int] = None
                          ) -> List[List[int]]:
    """This process's slab of every global batch of a deterministic order
    (JAX multihost.py:80-101): every process runs the same seeded shuffle
    and takes rows ``[pid * local, (pid + 1) * local)`` of each global
    batch; samples that do not fill a whole global batch are dropped."""
    rank, size = world()
    pid = rank if process_id is None else process_id
    nproc = size if num_processes is None else num_processes
    if global_batch_size % nproc:
        raise ValueError(f"global_batch_size {global_batch_size} must be "
                         f"divisible by process count {nproc}")
    local = global_batch_size // nproc
    out = []
    for i in range(0, len(order) - global_batch_size + 1, global_batch_size):
        g = order[i:i + global_batch_size]
        out.append(list(g[pid * local:(pid + 1) * local]))
    return out


def global_batch_from_local(local_stacked: Dict, mesh: Mesh,
                            axis: str = "dp", device="cuda") -> List[Dict]:
    """This process's micro-batches, from its local stacked pytree
    (``dp.stack_device_batches`` over its own slab), as tensors on its
    device (JAX multihost.py:104-118). In JAX this assembles one global
    array whose shards live in several processes; eager PyTorch has no
    array that spans processes, so the global batch exists only as each
    rank's local tensors, and the collectives of the step (dp.py) are what
    join them."""
    return [pytree_tensors(_tree_map(lambda x: x[i], local_stacked), device)
            for i in range(len(local_stacked["targets"]))]
