"""Segment/scatter primitives for message passing, in PyTorch.

The port's counterpart of polymer_chemprop_tpu ops/segment.py: incoming
bond messages are aggregated with a flat weighted segment sum over the bond
axis (``index_add_`` with destination-atom ids) instead of the reference's
dense ``(n_atoms, max_in_degree)`` gather (reference nn_utils.py:50-67,
mpn.py:110-120). These functions are the plain path of the encoder's
reference branch and the oracle the CUDA kernels are held against.
"""

from __future__ import annotations

import torch

from .band_mpnn import aggregate_molecules


def weighted_segment_sum(values: torch.Tensor, weights: torch.Tensor,
                         segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """sum_i weights[i] * values[i] grouped by segment_ids.

    values: (N, H); weights: (N,); segment_ids: (N,) int in
    [0, num_segments). Returns (num_segments, H)."""
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segment_ids.long(), values * weights[:, None])


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segment_ids.long(), values)


def bond_message_step(message: torch.Tensor, w_bonds: torch.Tensor,
                      b2a: torch.Tensor, b2dst: torch.Tensor,
                      b2revb: torch.Tensor, num_atoms: int) -> torch.Tensor:
    """One wD-MPNN directed-bond aggregation:

        m_new(a1->a2) = [sum_{b' into a1} w(b') * m(b')] - m(a2->a1)

    (reference mpn.py:110-120: weighted incoming sum minus the unweighted
    reverse message). Padded bonds carry zero weight and segment id 0."""
    a_message = weighted_segment_sum(message, w_bonds, b2dst, num_atoms)
    return a_message[b2a.long()] - message[b2revb.long()]


def atom_readout(message: torch.Tensor, w_bonds: torch.Tensor,
                 b2dst: torch.Tensor, num_atoms: int) -> torch.Tensor:
    """Final per-atom aggregation of incoming bond messages
    (reference mpn.py:126-131)."""
    return weighted_segment_sum(message, w_bonds, b2dst, num_atoms)


def molecule_readout(atom_hiddens: torch.Tensor, w_atoms: torch.Tensor,
                     a2mol: torch.Tensor, num_mols: int,
                     degree_of_polym: torch.Tensor,
                     aggregation: str = "mean",
                     aggregation_norm: float = 100.0) -> torch.Tensor:
    """Stoichiometry-weighted molecule readout (reference mpn.py:145-171).

    mean: sum(w*h) / sum(w)   (note: /sum(w), not /n_atoms — mpn.py:159)
    sum:  sum(w*h)
    norm: sum(w*h) / aggregation_norm
    then scaled by degree_of_polym = 1 + log10(Xn). Molecules with zero
    atoms get a zero vector (reference cached_zero_vector, mpn.py:148-149).
    The encoder's branch without the sorted layout; with it, the readout
    is ops/band_mpnn.py ``molecule_readout_sorted``.
    """
    wsum = weighted_segment_sum(atom_hiddens, w_atoms, a2mol, num_mols)
    denom = segment_sum(w_atoms, a2mol, num_mols)
    return aggregate_molecules(wsum, denom, degree_of_polym, aggregation,
                               aggregation_norm)
