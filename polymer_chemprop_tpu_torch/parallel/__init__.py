"""Several ranks: rank meshes, data-parallel and edge-partitioned training.

The port's counterpart of polymer_chemprop_tpu parallel/, one process a
rank (``torchrun``) over ``torch.distributed``:

* mesh.py: row-major rank meshes with a process group per axis line, and
  the collectives (gloo stages a card's tensors through host memory);
* dp.py: data parallelism with the exact global masked loss and one flat
  gradient all-reduce a step;
* partition.py: one batched graph's bonds split over the ranks, with a
  per-layer all-reduce or neighbour halo exchange, row 3's kernel inside
  every shard, and the 1-D and 2-D ``(dp, ep)`` train steps;
* multihost.py: process groups from torchrun or an address, the hybrid
  mesh, host-local input slabs;
* gspmd.py: the JAX package's GSPMD step's API, replicated (no SPMD
  partitioner in eager PyTorch).

Importing this package starts no process group and touches no device.
"""

from .dp import make_dp_train_step, shard_batch, stack_device_batches
from .gspmd import graph_shardings, make_gspmd_train_step
from .mesh import Mesh, make_mesh
from .multihost import (global_batch_from_local, initialize_multihost,
                        make_hybrid_mesh, process_batch_indices)
from .partition import (build_edge_shards, build_edge_shards_halo,
                        build_edge_shards_halo_band,
                        build_edge_shards_halo_dp, halo_strip_width,
                        make_edge_parallel_forward,
                        make_edge_parallel_forward_halo,
                        make_edge_parallel_forward_halo_band,
                        make_edge_parallel_forward_halo_overlap,
                        make_halo_dp_train_step, make_halo_train_step)

__all__ = ["build_edge_shards", "build_edge_shards_halo",
           "build_edge_shards_halo_dp", "halo_strip_width",
           "make_halo_dp_train_step",
           "make_edge_parallel_forward_halo_overlap",
           "global_batch_from_local", "initialize_multihost",
           "make_hybrid_mesh", "process_batch_indices",
           "make_edge_parallel_forward_halo", "make_halo_train_step",
           "build_edge_shards_halo_band",
           "make_edge_parallel_forward_halo_band", "graph_shardings",
           "make_dp_train_step", "make_gspmd_train_step",
           "make_edge_parallel_forward", "make_mesh", "shard_batch",
           "stack_device_batches", "Mesh"]
