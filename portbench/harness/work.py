"""The yardstick's arithmetic: the model operations a unit needs, and the
least time of each message-passing kernel, counted from a batch's real
molecules, atoms and bonds (padding is never counted).

Each kernel's counts sit in its own file under a roofline's
``kernels/``, as terms in the real counts; the four there are a frozen
copy of the port's ``chip_smoke.py`` ``work()`` (with
``probes/csr_rows_probe.py`` ``kernel_bytes`` and
``probes/readout_probe.py`` ``readout_bytes``): each input read once,
each output written once, the operations that the batch's runs need.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAK_BF16_TC_FLOPS = 989e12      # the fastest unit a kernel of the port uses
PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def linear_flops(cfg: dict, atom_fdim: int, bond_fdim: int, num_tasks: int,
                 mols: int, atoms: int, bonds: int) -> float:
    """Multiply-adds (x2) of one forward's linear layers: W_i on every
    directed bond, W_h in each of the depth - 1 updates, W_o on every atom
    and the FFN on every molecule."""
    H, F, depth = cfg["hidden_size"], cfg["ffn_hidden_size"], cfg["depth"]
    dims = [H] + [F] * (cfg["ffn_num_layers"] - 1) + [num_tasks]
    ffn = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    return 2.0 * (bonds * bond_fdim * H + (depth - 1) * bonds * H * H
                  + atoms * (atom_fdim + H) * H + mols * ffn)


def aggregation_flops(cfg: dict, mols: int, atoms: int, bonds: int) -> float:
    """One forward's sums: an fma per run element and a subtraction per
    element of each update, the atom readout's fma per bond element, the
    molecule readout's fma per atom element and its mean and scale."""
    H, depth = cfg["hidden_size"], cfg["depth"]
    return float((depth - 1) * 3 * bonds * H + 2 * bonds * H
                 + 2 * atoms * H + 3 * mols * H)


def unit_flops(cfg: dict, atom_fdim: int, bond_fdim: int, num_tasks: int,
               counts: tuple, training: bool) -> float:
    """Model operations of one unit: the forward, and for training the
    backward too (twice the linear layers' forward, once the sums')."""
    mols, atoms, bonds = counts
    lin = linear_flops(cfg, atom_fdim, bond_fdim, num_tasks,
                       mols, atoms, bonds)
    agg = aggregation_flops(cfg, mols, atoms, bonds)
    return 3 * lin + 2 * agg if training else lin + agg


PEAKS = {"fp32": PEAK_FP32_FLOPS, "bf16_tc": PEAK_BF16_TC_FLOPS}


def evaluate(expr: Dict[str, float], **values: float) -> float:
    """A sum of terms: each key a product of variable names joined by
    ``*`` (``"1"`` for the constant term), each value its coefficient."""
    total = 0.0
    for term, coef in expr.items():
        x = float(coef)
        if term != "1":
            for name in term.split("*"):
                x *= values[name]
        total += x
    return total


def kernel_work(spec: dict, H: int, mols: int, atoms: int,
                bonds: int) -> Dict[str, float]:
    """``{"bytes", "ops", "peak"}`` of one call of the kernel that
    ``spec`` (a file under a roofline's ``kernels/``) describes, on a
    batch with these real counts: its ``bytes`` and ``ops`` in H, M
    (molecules), A (atoms) and B (directed bonds), and its peak's name."""
    v = dict(H=H, M=mols, A=atoms, B=bonds)
    return {"bytes": evaluate(spec["bytes"], **v),
            "ops": evaluate(spec["ops"], **v), "peak": PEAKS[spec["peak"]]}


def kernel_calls(spec: dict, depth: int) -> int:
    """Launches of the kernel a unit: its ``calls`` in D, the depth."""
    return int(round(evaluate(spec["calls"], D=depth)))


def least_seconds(work: Dict[str, float]) -> float:
    """The roofline's least time: bytes at the HBM rate or operations at
    the peak, whichever takes longer."""
    return max(work["bytes"] / PEAK_HBM_BYTES, work["ops"] / work["peak"])
