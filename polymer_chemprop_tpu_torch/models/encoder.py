"""wD-MPNN bond-message graph encoder in PyTorch.

Semantics match polymer_chemprop_tpu models/encoder.py and the reference
MPNEncoder (reference mpn.py:14-173):

* ``inputs = W_i(f_bonds)``; ``message = act(inputs)``              (mpn.py:93-97)
* depth-1 iterations of the weighted directed-bond update
  ``m(a1->a2) = [sum_{a0 in N(a1)} w(a0->a1) m(a0->a1)] - m(a2->a1)``
  followed by ``message = act(inputs + W_h(message))``: the residual is to
  the *layer-0* input (mpn.py:110-124)
* atom readout: weighted incoming sum, concat with f_atoms, W_o, act
  (mpn.py:126-134)
* molecule readout: stoichiometry-weighted aggregation scaled by
  1+log10(Xn) (mpn.py:145-171); with ``"sorted_aux"``
  :func:`~..ops.band_mpnn.molecule_readout_sorted` over the batch's
  molecule CSR, else the segment sums of ops/segment.py

With ``atom_messages`` the messages live on atoms (reference
mpn.py:93-108, the JAX package's encoder.py:121-187): ``inputs =
W_i(f_atoms)``; W_h takes ``(H + bond_fdim)`` inputs, and its bond-feature
half acts on the loop-invariant ``f_sum[v]``, the sum of the bond features
(without the source atom's) of v's incoming bonds, once before the loop
with W_h's bias (``const``); each of the ``depth - 1`` layers is
``act(inputs + W_h[:, :H](N message) + const)`` with N the neighbour sum;
the readout weights every incoming bond by its own weight,
``a[v] = sum_{c: dst c = v} w[c] message[src c]``. That weighting is the
JAX package's deliberate departure from the reference, which indexes the
bond weights by neighbour atom ids (docs/parity.md). With ``"sorted_aux"``
the neighbour sum and the readout are :func:`~..ops.band_mpnn.
atom_neighbor_sum_sorted` and :func:`~..ops.band_mpnn.src_readout_sorted`
(one kernel, FP32 sums at either compute dtype), and ``f_sum`` is
:func:`~..ops.band_mpnn.atom_readout` with unit weights over the
dst-sorted bond features; without it, segment sums over ``b2a`` /
``b2dst``.

For bond messages there are two branches, chosen by the batch:

* with ``"sorted_aux"`` (the loader's default), messages stay in dst-sorted
  bond order, each layer runs in one of three forms (below), and one
  :func:`~..ops.band_mpnn.atom_readout` follows. On CUDA tensors these
  launch the hand-written kernels; on CPU tensors they run their plain
  versions. This mirrors the JAX package's sorted-resident branch
  (encoder.py:188-280).
* without it, the reference branch runs the plain segment sums in natural
  bond order, mirroring the JAX package's XLA branch (encoder.py:281-292).

The layer form of the sorted branch is chosen from the configuration alone
(:meth:`EncoderConfig.layer_form`), as the JAX package chooses it
(encoder.py:207-259), so the CPU takes the same form as the card:

* ``"rev"``: no bias, float32, directed, and a hidden size whose tile fits
  a block's shared memory: one :func:`~..ops.band_mpnn.band_rev_layer` call
  per layer, no gather.
* ``"matmul_act"``: the same but ``undirected``: the messages are
  symmetrized with their reverses before each layer, which needs the
  explicit ``srev`` gather, so the layer is
  :func:`~..ops.band_mpnn.band_matmul_act_step_sorted` on the residual
  pre-permuted once before the loop.

  The product of these two forms runs at the configuration's
  ``band_precision``, as the JAX package's band kernels do: ``"high"``
  (the default; three bf16 passes on the tensor cores), ``"default"``
  (one pass) or ``"highest"`` (FP32). The ``plain`` form computes FP32
  (or bfloat16 linear layers) at every setting.
* ``"plain"``: ``bias``, bfloat16 compute or a wider hidden size: the W_h
  product is not fused; the layer is
  :func:`~..ops.band_mpnn.band_message_step_sorted` (the plain band
  aggregation and the ``srev`` gather), then W_h through
  :func:`~.nn.linear` and the residual and activation in PyTorch ops.

With ``bias`` the padding rows are not zero (``W_i(0) + b``); they lie in no
atom's run, are their own reverse and carry weight 0, so no real row and no
atom reads them.

With ``atom_descriptors="descriptor"`` the atom hiddens are concatenated
with the batch's per-atom descriptors ``(A, D)`` and go through ``W_d``,
an ``(H + D) -> (H + D)`` linear layer with a bias and no activation (JAX
encoder.py:82-84, 306-309), before the molecule readout; so the encoder's
output is ``H + D`` wide. With ``"feature"`` the descriptors widen the atom
features instead (``atom_fdim``), and nothing here changes.

In training mode (``module.train()``) dropout is applied where the JAX
package applies it (encoder.py:263-266, 291, 304, 309): after every
depth-loop layer, after the atom hiddens and after ``W_d``, from an
explicit ``torch.Generator``. Both
branches are differentiable: the kernel branch through the hand-written
``torch.autograd.Function``s of ops/band_mpnn.py, the reference branch
through PyTorch's own autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.band_mpnn import atom_readout as atom_readout_sorted
from ..ops.band_mpnn import (
    atom_neighbor_sum_sorted,
    band_matmul_act_step_sorted,
    band_message_step_sorted,
    band_rev_layer,
    check_precision,
    fused_layer_fits,
    molecule_readout_sorted,
    permute_rows,
    src_readout_sorted,
)
from ..ops.segment import (
    atom_readout,
    bond_message_step,
    molecule_readout,
    segment_sum,
    weighted_segment_sum,
)
from .nn import dense, dropout, get_activation, linear


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Static encoder hyperparameters (the JAX package's EncoderConfig,
    reference args.py:309-359)."""

    atom_fdim: int
    bond_fdim: int
    hidden_size: int = 300
    depth: int = 3
    dropout: float = 0.0
    activation: str = "relu"
    aggregation: str = "mean"
    aggregation_norm: float = 100.0
    bias: bool = False
    undirected: bool = False
    atom_messages: bool = False
    atom_descriptors: Optional[str] = None
    atom_descriptors_size: int = 0
    compute_dtype: str = "float32"
    band_precision: str = "high"

    def __post_init__(self):
        check_precision(self.band_precision)

    def check_supported(self) -> None:
        """Raise for the configurations the JAX package refuses."""
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: expected "
                             "'float32' or 'bfloat16'")
        if self.atom_messages and self.undirected:
            raise ValueError("Undirected is unnecessary when using "
                             "atom_messages (reference args.py:588-590)")

    def layer_form(self) -> str:
        """``"rev"``, ``"matmul_act"`` or ``"plain"``: the depth-loop layer
        of the sorted bond-message branch (module docstring), from the shape
        and the options alone. It does not apply to ``atom_messages``,
        whose layer is the neighbour sum at every setting."""
        fused = (not self.bias and self.compute_dtype == "float32"
                 and fused_layer_fits(self.hidden_size))
        if not fused:
            return "plain"
        return "matmul_act" if self.undirected else "rev"


class MPNEncoder(nn.Module):
    """One message-passing encoder (reference mpn.py:46-64): W_i and W_h
    with a bias only when ``cfg.bias``, W_o always with one, and W_d (with
    a bias) in the ``"descriptor"`` mode. Weights use torch's (out, in)
    layout. With ``atom_messages`` W_i takes the atom features and W_h
    ``H + bond_fdim`` inputs (JAX encoder.py:74-75)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        H = cfg.hidden_size
        extra = cfg.bond_fdim if cfg.atom_messages else 0
        self.W_i = nn.Linear(cfg.atom_fdim if cfg.atom_messages
                             else cfg.bond_fdim, H, bias=cfg.bias)
        self.W_h = nn.Linear(H + extra, H, bias=cfg.bias)
        self.W_o = nn.Linear(cfg.atom_fdim + H, H, bias=True)
        if cfg.atom_descriptors == "descriptor":
            d = H + cfg.atom_descriptors_size
            self.W_d = nn.Linear(d, d, bias=True)
        self.act_name = cfg.activation.lower()
        self.act = get_activation(self.act_name)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                atom_descriptors: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Encode one GraphBatch (tensors) -> (num_mols, hidden), or
        (num_mols, hidden + D) when ``atom_descriptors`` ``(A, D)`` is given
        (the ``"descriptor"`` mode). ``generator`` feeds the dropout masks
        in training mode."""
        cfg = self.cfg

        def drop(x):
            return dropout(x, cfg.dropout, self.training, generator)

        bf16 = cfg.compute_dtype == "bfloat16"
        f_atoms = batch["f_atoms"]
        if cfg.atom_messages:
            a_message = self._atom_messages(batch, drop, bf16)
        else:
            a_message = self._bond_messages(batch, drop, bf16)
        atom_hiddens = drop(self.act(
            linear(self.W_o, torch.cat([f_atoms, a_message], 1), bf16)))
        if atom_descriptors is not None:
            atom_hiddens = drop(linear(
                self.W_d, torch.cat([atom_hiddens, atom_descriptors], 1),
                bf16))
        aux = batch.get("sorted_aux")
        if aux is not None:
            return molecule_readout_sorted(
                atom_hiddens, batch["w_atoms"], batch["a2mol"], aux,
                batch["degree_of_polym"], aggregation=cfg.aggregation,
                aggregation_norm=cfg.aggregation_norm)
        return molecule_readout(atom_hiddens, batch["w_atoms"],
                                batch["a2mol"],
                                batch["degree_of_polym"].shape[0],
                                batch["degree_of_polym"],
                                aggregation=cfg.aggregation,
                                aggregation_norm=cfg.aggregation_norm)

    def encode_parts(self, batch: Dict[str, torch.Tensor]):
        """``(message, atom_hiddens)``: the final bond messages ``(B, H)``
        in the batch's bond order (dst-sorted with ``"sorted_aux"``) and
        the atom hiddens ``(A, H)``, with no dropout whatever the mode,
        as the JAX package's SSL heads read them (JAX ssl.py:161-180). Bond
        messages only."""
        bf16 = self.cfg.compute_dtype == "bfloat16"
        message, a_message = self._bond_message_passing(
            batch, lambda x: x, bf16)
        atom_hiddens = self.act(linear(
            self.W_o, torch.cat([batch["f_atoms"], a_message], 1), bf16))
        return message, atom_hiddens

    def _bond_messages(self, batch, drop, bf16: bool) -> torch.Tensor:
        """The bond-message depth loop and readout (module docstring) ->
        a_message (A, H)."""
        return self._bond_message_passing(batch, drop, bf16)[1]

    def _bond_message_passing(self, batch, drop, bf16: bool):
        """-> ``(message, a_message)``: the final bond messages and their
        atom readout."""
        cfg = self.cfg
        num_atoms = batch["f_atoms"].shape[0]
        inputs = linear(self.W_i, batch["f_bonds"], bf16)
        message = self.act(inputs)
        aux = batch.get("sorted_aux")
        if aux is not None:
            # f_bonds arrive dst-sorted; messages stay sorted throughout
            form = cfg.layer_form()
            srev = aux["srev"]
            if form != "plain" and cfg.depth > 1:
                # (in, out) for the kernels
                wh = self.W_h.weight.t().contiguous()
            if form == "matmul_act" and cfg.depth > 1:
                # act(inputs + x[srev]) == act(inputs[srev] + x)[srev]; the
                # permuted residual is the same for every layer
                inputs_srev = permute_rows(inputs, srev, srev)
            for _ in range(cfg.depth - 1):
                if cfg.undirected:
                    message = (message + permute_rows(message, srev, srev)) / 2
                if form == "rev":
                    message = band_rev_layer(
                        message, inputs, wh, aux["w_sorted"],
                        aux["src_sorted"], srev, aux["rowptr"], self.act_name,
                        cfg.band_precision)
                elif form == "matmul_act":
                    message = band_matmul_act_step_sorted(
                        message, wh, inputs_srev, aux, self.act_name,
                        cfg.band_precision)
                else:
                    message = band_message_step_sorted(message, aux)
                    message = self.act(inputs + linear(self.W_h, message, bf16))
                message = drop(message)
            return message, atom_readout_sorted(
                message, aux["w_sorted"], aux["rowptr"], aux["dst_sorted"])
        w_bonds, b2dst = batch["w_bonds"], batch["b2dst"]
        for _ in range(cfg.depth - 1):
            if cfg.undirected:
                message = (message + message[batch["b2revb"]]) / 2
            message = bond_message_step(message, w_bonds, batch["b2a"],
                                        b2dst, batch["b2revb"], num_atoms)
            # layer-0 residual (mpn.py:123)
            message = drop(self.act(
                inputs + linear(self.W_h, message, bf16)))
        return message, atom_readout(message, w_bonds, b2dst, num_atoms)

    def _atom_messages(self, batch, drop, bf16: bool) -> torch.Tensor:
        """The atom-message depth loop and readout (module docstring; JAX
        encoder.py:121-187) -> a_message (A, H)."""
        cfg = self.cfg
        H = cfg.hidden_size
        num_atoms = batch["f_atoms"].shape[0]
        aux = batch.get("sorted_aux")
        # the bond features without the source atom's (reference
        # featurization.py:838-843)
        f_bonds = batch["f_bonds"][:, -cfg.bond_fdim:]
        if aux is None:
            f_sum = segment_sum(f_bonds, batch["b2dst"], num_atoms)
        else:
            # f_bonds arrive dst-sorted with the aux
            f_sum = atom_readout_sorted(
                f_bonds.contiguous(), torch.ones_like(aux["w_sorted"]),
                aux["rowptr"])
        w_h = self.W_h.weight
        const = dense(f_sum, w_h[:, H:], self.W_h.bias, bf16)
        inputs = linear(self.W_i, batch["f_atoms"], bf16)
        message = self.act(inputs)
        for _ in range(cfg.depth - 1):
            if aux is not None:
                m = atom_neighbor_sum_sorted(message, aux)
            else:
                m = segment_sum(message[batch["b2a"]], batch["b2dst"],
                                num_atoms)
            message = drop(self.act(inputs + dense(m, w_h[:, :H], None, bf16)
                                    + const))
        if aux is not None:
            return src_readout_sorted(message, aux)
        return weighted_segment_sum(message[batch["b2a"]], batch["w_bonds"],
                                    batch["b2dst"], num_atoms)


# index arrays the kernels read as int32; the rest index with int64
_KERNEL_INDEX_KEYS = ("src_sorted", "srev", "rowptr", "mol_idx",
                      "mol_rowptr")


def batch_to_tensors(arrays: Dict, device) -> Dict:
    """One GraphBatch's numpy arrays -> tensors on ``device``: floats as
    float32, natural-order indices as int64, the kernels' indices as
    contiguous int32."""
    def conv(k, v):
        if v.dtype.kind == "f":
            return torch.as_tensor(v, dtype=torch.float32, device=device)
        dtype = torch.int32 if k in _KERNEL_INDEX_KEYS else torch.int64
        return torch.as_tensor(v, dtype=dtype, device=device).contiguous()

    out = {k: conv(k, v) for k, v in arrays.items() if k != "sorted_aux"}
    if "sorted_aux" in arrays:
        out["sorted_aux"] = {k: conv(k, v)
                             for k, v in arrays["sorted_aux"].items()}
    return out

