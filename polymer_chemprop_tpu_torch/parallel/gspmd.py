"""The JAX package's GSPMD train step, in eager PyTorch.

The port's counterpart of polymer_chemprop_tpu parallel/gspmd.py. There,
the jitted step is given input shardings (the graph's atom and bond axes
over the mesh, parameters replicated) and XLA's SPMD partitioner inserts
the collectives. Eager PyTorch has no SPMD partitioner, so this keeps the
API and the update, not the scaling: the batch arrives row-sharded as
:func:`graph_shardings` says (each rank places its rows on its device, as
the JAX step's ``device_put`` does), is all-gathered, and every rank runs
the replicated single-device step on the whole batch, the gradients
averaged over the ranks so that every rank keeps the same parameters. It
buys no scaling on the port: every rank does the whole batch's work. The
edge-partitioned steps of partition.py are the port's way to split a
graph.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.encoder import batch_to_tensors
from ..ops.sorted_aux import build_molecule_csr, build_sorted_aux
from ..train.step import TrainStep, make_loss_fn
from .mesh import Mesh, all_gather
from .partition import _device_of, flat_all_reduce

ROW, REPLICATED = "row", "replicated"


def graph_shardings(mesh: Mesh, axis: str = "gp") -> Dict[str, str]:
    """How each GraphBatch array is laid over ``axis`` (JAX
    gspmd.py:27-37): the atom and bond axes split into row blocks, the
    per-molecule arrays replicated."""
    return {"f_atoms": ROW, "f_bonds": ROW, "w_atoms": ROW, "w_bonds": ROW,
            "b2a": ROW, "b2dst": ROW, "b2revb": ROW, "a2mol": ROW,
            "degree_of_polym": REPLICATED, "mol_mask": REPLICATED}


def make_gspmd_train_step(model, optimizer, schedule, mesh: Mesh,
                          axis: str = "gp", target_weights=None,
                          grad_clip=None):
    """Train step whose graph arrays are sharded over ``axis`` (JAX
    gspmd.py:40-74; module docstring). ``step(batch) -> (loss, gnorm)``
    takes the batch pytree (``train.step.batch_pytree``, one molecule
    position, natural bond order); the atom and bond axes must divide by
    the axis size."""
    shardings = graph_shardings(mesh, axis)
    group = mesh.group(axis)
    n = mesh.shape[axis]
    c = mesh.coord(axis)
    inner = TrainStep(model, optimizer, schedule,
                      make_loss_fn(model.cfg, target_weights),
                      grad_clip=grad_clip,
                      reduce=flat_all_reduce(group, scale=1.0 / n))

    def step(batch: Dict):
        dev = _device_of(model)
        arrays = batch["graphs"][0]
        local = {}
        for k, spec in shardings.items():
            x = np.asarray(arrays[k])
            if spec == ROW:
                if x.shape[0] % n:
                    raise ValueError(f"{k}: {x.shape[0]} rows do not split "
                                     f"over {n} ranks")
                rows = x.shape[0] // n
                x = x[c * rows:(c + 1) * rows]
            local[k] = x
        t = batch_to_tensors(local, dev)
        # the collective XLA would insert: every rank gets every row block
        for k, spec in shardings.items():
            if spec == ROW:
                t[k] = torch.cat(all_gather(t[k], group))
        aux = build_sorted_aux(t["b2dst"].cpu().numpy(),
                               t["b2revb"].cpu().numpy(),
                               t["w_bonds"].cpu().numpy(),
                               num_atoms=t["f_atoms"].shape[0])
        mol_csr = build_molecule_csr(t["a2mol"].cpu().numpy(),
                                     t["w_atoms"].cpu().numpy(),
                                     t["degree_of_polym"].shape[0])
        sorted_aux = batch_to_tensors(dict(aux._asdict(), **mol_csr), dev)
        t["f_bonds"] = t["f_bonds"][sorted_aux["perm"]]
        t["sorted_aux"] = sorted_aux
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                         device=dev)
        return inner({"graphs": [t], "targets": as_t(batch["targets"]),
                      "mask": as_t(batch["mask"]),
                      "weights": as_t(batch["weights"])})

    return step
