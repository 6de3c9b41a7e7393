"""The port's CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no CPU mode, so every test here is marked ``gpu``
and skips where no GPU is present. This file imports no JAX, so it also
runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Tolerance: FP32 with another summation order,
max|kernel - plain| <= 1e-5 * max|plain| + 1e-6; the tensor-core stage
(``band_precision`` "high" and "default", of ``band_rev_layer``,
``band_matmul_act`` and ``band_matmul``) against the plain version at the
same precision, the same arithmetic summed in another order, with the same
tolerance on the pre-activation (``_close_act``).
"""

import numpy as np
import pytest
import torch

from polymer_chemprop_tpu_torch.features import FeaturizationConfig
from polymer_chemprop_tpu_torch.features import mol2graph
from polymer_chemprop_tpu_torch.ops import band_mpnn, probe_kernels
from polymer_chemprop_tpu_torch.ops.sorted_aux import build_sorted_aux

POLYMERS = ["[*:1]CC[*:2].[*:3]CO[*:4]|0.5|0.5|<1-3:0.5:0.5<2-4:0.5:0.5~20",
            "[*:1]c1ccc([*:2])cc1.[*:3]C(C)C[*:4]|0.25|0.75|"
            "<1-3:0.25:0.75<2-4:0.75:0.25~100"] * 8
SMILES = ["CCO", "c1ccccc1", "CC(C)=CCCC(C)=CC(=O)",
          "CCOc1ccc2nc(S(N)(=O)=O)sc2c1"] * 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(kind, H, dev):
    polymer = kind == "polymer"
    gb = mol2graph(POLYMERS if polymer else SMILES,
                   FeaturizationConfig(polymer=polymer))
    aux = build_sorted_aux(gb.b2dst, gb.b2revb, gb.w_bonds,
                           num_atoms=gb.f_atoms.shape[0])
    B, n_real = gb.f_bonds.shape[0], int(aux.rowptr[-1])
    rng = np.random.default_rng(0)
    real = np.zeros((B, 1), np.float32)
    real[:n_real] = 1.0
    T = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    m = T(rng.normal(size=(B, H)).astype(np.float32) * real)
    inp = T(rng.normal(size=(B, H)).astype(np.float32) * real)
    wh = T((rng.normal(size=(H, H)) * 0.1).astype(np.float32))
    aux_t = {k: T(v) for k, v in aux._asdict().items()}
    return m, inp, wh, aux_t, n_real


def _close(got, want):
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-6, err


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("act", band_mpnn.ACT_IDS)
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 300, 333])
def test_band_rev_layer_matches_plain(cuda, kind, act, H, precision):
    """At "highest" the FP32 entry against the plain version; at "high"
    and "default" the tensor-core entry against the plain product at the
    same precision on the kernel's own z and, at "high", on the plain z
    (``_tc_product_refs``). Padding rows stay exactly 0 at every
    precision."""
    from polymer_chemprop_tpu_torch.models.nn import get_activation
    m, inp, wh, a, n_real = _batch(kind, H, cuda)
    idx = (a["w_sorted"], a["src_sorted"], a["srev"], a["rowptr"])
    got, launches = _tc_delta(band_mpnn.band_rev_layer, m, inp, wh, *idx,
                              act, precision)
    tc = precision != "highest"
    assert launches == [{"band_rev_layer": 1},
                        {"band_rev_layer": 1} if tc else {}]
    if not tc:
        _close(got, band_mpnn.band_rev_layer_plain(m, inp, wh, *idx, act))
    else:
        _, z = band_mpnn.band_rev_layer_forward(m, inp, wh, *idx, act, True,
                                                precision)
        z_plain = band_mpnn.band_rev_z_plain(m, *idx)
        for pre in _tc_product_refs(z, z_plain, wh, precision, inp):
            want = get_activation(act)(pre)
            _close_act(got, want, pre, act)
            if act == "relu":
                _close(got, want)
    torch.cuda.synchronize()
    assert (got[n_real:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 37, 300, 333, 1600])
def test_atom_readout_matches_plain(cuda, kind, H):
    m, _, _, a, _ = _batch(kind, H, cuda)
    got = band_mpnn.atom_readout(m, a["w_sorted"], a["rowptr"])
    _close(got, band_mpnn.atom_readout_plain(m, a["w_sorted"], a["rowptr"]))
    assert (got[0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 300, 333])
def test_band_rev_bwd_matches_plain(cuda, kind, H):
    g, _, _, a, n_real = _batch(kind, H, cuda)
    # a cotangent is not zero on padding rows
    g = g + torch.randn(g.shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
    args = (g, a["w_sorted"], a["srev"], a["rowptr"])
    before = band_mpnn.band_rev_bwd.launches
    got = band_mpnn.band_rev_bwd(*args)
    assert band_mpnn.band_rev_bwd.launches == before + 1
    _close(got, band_mpnn.band_rev_bwd_plain(*args))
    # padding rows are their own reverse with zero weight: dm = -g
    assert torch.equal(got[n_real:], -g[n_real:])


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 300, 1495])
def test_band_rev_layer_writes_z(cuda, kind, H, precision):
    """z against the plain z, 0 on padding rows, and on the tensor-core
    entry bit for bit the FP32 entry's z; the output the same with z on
    and off."""
    m, inp, wh, a, n_real = _batch(kind, H, cuda)
    idx = (a["w_sorted"], a["src_sorted"], a["srev"], a["rowptr"])
    out, z = band_mpnn.band_rev_layer_forward(m, inp, wh, *idx, "relu",
                                              True, precision)
    _close(z, band_mpnn.band_rev_z_plain(m, *idx))
    assert (z[n_real:] == 0).all()
    out_only, none = band_mpnn.band_rev_layer_forward(
        m, inp, wh, *idx, "relu", False, precision)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, out_only)
    if precision != "highest":
        z_f32 = band_mpnn.band_rev_layer_forward(m, inp, wh, *idx, "relu",
                                                 True, "highest")[1]
        torch.cuda.synchronize()
        assert torch.equal(z, z_f32)


@pytest.mark.gpu
@pytest.mark.parametrize("act", band_mpnn.ACT_IDS)
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_function_gradients_match_autograd_through_plain(cuda, kind, act):
    """(dm, dW_h, dinp) of the layer and dm of the readout, from the
    hand-written backward with its kernels, against PyTorch's autograd
    through the plain versions on the card. Tolerance as for the kernels,
    relative to each gradient's largest entry."""
    H = 300
    m, inp, wh, a, _ = _batch(kind, H, cuda)
    idx = (a["w_sorted"], a["src_sorted"], a["srev"], a["rowptr"])
    # keep every pre-activation 1e-3 away from 0, where a kinked
    # activation's derivative would hang on the forward's last rounding
    pre = inp + band_mpnn.band_rev_z_plain(m, *idx) @ wh
    inp = torch.where(pre.abs() < 1e-3,
                      inp + torch.where(pre >= 0, 2e-3, -2e-3), inp)
    gen = torch.Generator(cuda).manual_seed(2)
    g_out = torch.randn(m.shape, device=cuda, generator=gen)
    g_atoms = torch.randn((a["rowptr"].shape[0] - 1, H), device=cuda,
                          generator=gen)

    def grads(layer, readout):
        leaves = [t.clone().requires_grad_(True) for t in (m, wh, inp)]
        out = layer(leaves[0], leaves[2], leaves[1], *idx, act)
        atoms = readout(out)
        return torch.autograd.grad(
            [out, atoms], leaves, [g_out, g_atoms])

    before = band_mpnn.launch_counts()
    got = grads(band_mpnn.band_rev_layer,
                lambda x: band_mpnn.atom_readout(
                    x, a["w_sorted"], a["rowptr"], a["dst_sorted"].long()))
    after = band_mpnn.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {
        "band_rev_layer": 1, "band_rev_bwd": 1, "atom_readout": 1}
    want = grads(band_mpnn.band_rev_layer_plain,
                 lambda x: band_mpnn.atom_readout_plain(x, a["w_sorted"],
                                                        a["rowptr"]))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.gpu
def test_inference_does_not_write_z(cuda, monkeypatch):
    m, inp, wh, a, _ = _batch("molecules", 32, cuda)
    seen = []
    real = band_mpnn.band_rev_layer_forward
    # want_z, the ninth argument
    monkeypatch.setattr(band_mpnn, "band_rev_layer_forward",
                        lambda *args: seen.append(args[8]) or real(*args))
    args = (m, inp, wh, a["w_sorted"], a["src_sorted"], a["srev"],
            a["rowptr"], "relu")
    band_mpnn.band_rev_layer(*args)
    with torch.inference_mode():
        band_mpnn.band_rev_layer(*args)
    band_mpnn.band_rev_layer(m.clone().requires_grad_(True), *args[1:])
    assert seen == [False, False, True]


# -- the plain-band kernels ------------------------------------------------------

def _plain_band_operands(kind, H, dev):
    """m, inp, cotangent (none zero on padding rows: a bias makes the
    encoder's so), wh and the index tensors."""
    m, inp, wh, a, n_real = _batch(kind, H, dev)
    gen = torch.Generator(dev).manual_seed(3)
    noise = lambda: torch.randn(m.shape, device=dev, generator=gen)
    return m + noise(), inp + noise(), noise(), wh, a, n_real


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 37, 300, 333, 1600])
def test_band_agg_matches_plain(cuda, kind, H):
    m, _, _, _, a, n_real = _plain_band_operands(kind, H, cuda)
    before = band_mpnn.band_agg.launches
    got = band_mpnn.band_agg(m, a["w_sorted"], a["rowptr"])
    assert band_mpnn.band_agg.launches == before + 1
    _close(got, band_mpnn.band_agg_plain(m, a["w_sorted"], a["rowptr"]))
    # padding rows lie in no run: z = -m, bit for bit
    assert n_real < m.shape[0]
    assert torch.equal(got[n_real:], -m[n_real:])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 300, 333, 1600])
def test_band_bwd_matches_plain(cuda, kind, H):
    _, _, g, _, a, n_real = _plain_band_operands(kind, H, cuda)
    before = band_mpnn.band_bwd.launches
    got = band_mpnn.band_bwd(g, a["w_sorted"], a["rowptr"])
    assert band_mpnn.band_bwd.launches == before + 1
    _close(got, band_mpnn.band_bwd_plain(g, a["w_sorted"], a["rowptr"]))
    assert torch.equal(got[n_real:], -g[n_real:])


@pytest.mark.gpu
@pytest.mark.parametrize("act", band_mpnn.ACT_IDS)
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 300, 333])
def test_band_matmul_act_matches_plain_with_z_on_and_off(cuda, kind, act, H):
    m, inp, _, wh, a, n_real = _plain_band_operands(kind, H, cuda)
    args = (m, inp, wh, a["w_sorted"], a["rowptr"], act)
    before = band_mpnn.launch_counts()
    out, z = band_mpnn.band_matmul_act_forward(*args, want_z=True)
    out_only, none = band_mpnn.band_matmul_act_forward(*args, want_z=False)
    after = band_mpnn.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"band_matmul_act": 2}
    assert none is None and torch.equal(out, out_only)
    _close(out, band_mpnn.band_matmul_act_plain(*args))
    z_plain = band_mpnn.band_agg_plain(m, a["w_sorted"], a["rowptr"])
    _close(z, z_plain)
    assert torch.equal(z[n_real:], -m[n_real:])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 300, 333])
def test_band_matmul_matches_plain(cuda, kind, H):
    m, _, _, wh, a, n_real = _plain_band_operands(kind, H, cuda)
    args = (m, wh, a["w_sorted"], a["rowptr"])
    before = band_mpnn.launch_counts()
    out, z = band_mpnn.band_matmul_forward(*args)
    after = band_mpnn.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"band_matmul": 1}
    out_plain, z_plain = band_mpnn.band_matmul_plain(*args)
    _close(out, out_plain)
    _close(z, z_plain)
    assert torch.equal(z[n_real:], -m[n_real:])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_padding_rows_of_m_reach_no_real_row(cuda, kind):
    m, inp, _, wh, a, n_real = _plain_band_operands(kind, 300, cuda)
    m2 = m.clone()
    m2[n_real:] = 100.0
    idx = (a["w_sorted"], a["rowptr"])
    for fn in (lambda x: band_mpnn.band_agg(x, *idx),
               lambda x: band_mpnn.band_matmul(x, wh, *idx),
               lambda x: band_mpnn.band_matmul_act(x, inp, wh, *idx, "tanh")):
        assert torch.equal(fn(m)[:n_real], fn(m2)[:n_real])


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "tanh", "selu"])
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_plain_band_function_gradients_match_autograd_through_plain(
        cuda, kind, act):
    """The three Functions' hand-written backward (kernel 5 and two
    products) against PyTorch's autograd through the plain versions, on the
    card. Tolerance as for the kernels, relative to each gradient's largest
    entry."""
    H = 300
    m, inp, g, wh, a, _ = _plain_band_operands(kind, H, cuda)
    idx = (a["w_sorted"], a["rowptr"])
    # keep every pre-activation 1e-3 away from 0 (see the rev-fused test)
    pre = inp + band_mpnn.band_agg_plain(m, *idx) @ wh
    inp = torch.where(pre.abs() < 1e-3,
                      inp + torch.where(pre >= 0, 2e-3, -2e-3), inp)
    cases = [
        ((m,), lambda x: band_mpnn.band_agg(x, *idx),
         lambda x: band_mpnn.band_agg_plain(x, *idx),
         {"band_agg": 1, "band_bwd": 1}),
        ((m, wh), lambda x, w: band_mpnn.band_matmul(x, w, *idx),
         lambda x, w: band_mpnn.band_matmul_plain(x, w, *idx)[0],
         {"band_matmul": 1, "band_bwd": 1}),
        ((m, wh, inp),
         lambda x, w, i: band_mpnn.band_matmul_act(x, i, w, *idx, act),
         lambda x, w, i: band_mpnn.band_matmul_act_plain(x, i, w, *idx, act),
         {"band_matmul_act": 1, "band_bwd": 1}),
    ]
    for operands, fn, plain, launches in cases:
        def grads(f):
            leaves = [t.clone().requires_grad_(True) for t in operands]
            return torch.autograd.grad(f(*leaves), leaves, g)

        before = band_mpnn.launch_counts()
        got = grads(fn)
        after = band_mpnn.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == launches
        for a_, b_ in zip(got, grads(plain)):
            _close(a_, b_)


@pytest.mark.gpu
def test_permute_rows_on_the_card(cuda):
    _, _, g, _, a, _ = _plain_band_operands("polymer", 32, cuda)
    x = g.clone().requires_grad_(True)
    out = band_mpnn.permute_rows(x, a["srev"], a["srev"])
    assert torch.equal(out, g[a["srev"].long()])
    dx, = torch.autograd.grad(out, x, g)
    assert torch.equal(dx, g[a["srev"].long()])


@pytest.mark.gpu
def test_smem_arithmetic_equals_the_libraries(cuda):
    from polymer_chemprop_tpu_torch.kernels.build import load
    for H in (32, 300, 1495, 1496, 2400):
        want = band_mpnn.fused_layer_smem_bytes(H)
        assert load("band_rev_layer").band_rev_layer_smem_bytes(H) == want
        assert load("band_matmul").band_matmul_smem_bytes(H) == want
    m, inp, _, _, a, _ = _plain_band_operands("molecules", 1600, cuda)
    wh = torch.zeros((1600, 1600), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        band_mpnn.band_matmul(m, wh, a["w_sorted"], a["rowptr"])
    # the widest model that fits launches
    m, inp, _, _, a, _ = _plain_band_operands("molecules", 1495, cuda)
    wh = torch.eye(1495, device=cuda)
    out, z = band_mpnn.band_matmul_forward(m, wh, a["w_sorted"], a["rowptr"])
    _close(out, z)


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs(cuda):
    m, inp, wh, a, _ = _batch("molecules", 32, cuda)
    with pytest.raises(TypeError):
        band_mpnn.band_rev_layer(m.double(), inp, wh, a["w_sorted"],
                                 a["src_sorted"], a["srev"], a["rowptr"],
                                 "relu")
    with pytest.raises(ValueError, match="contiguous"):
        band_mpnn.atom_readout(m.t().contiguous().t(), a["w_sorted"],
                               a["rowptr"])
    with pytest.raises(TypeError):
        band_mpnn.band_rev_bwd(m, a["w_sorted"], a["srev"].long(),
                               a["rowptr"])
    with pytest.raises(TypeError):
        band_mpnn.band_agg(m, a["w_sorted"], a["rowptr"].long())
    with pytest.raises(ValueError, match="shape"):
        band_mpnn.band_bwd(m, a["w_sorted"][:-1], a["rowptr"])
    with pytest.raises(ValueError, match="contiguous"):
        band_mpnn.band_matmul(m, wh.t(), a["w_sorted"], a["rowptr"])
    with pytest.raises(ValueError, match="shape"):
        band_mpnn.band_matmul_act(m, inp[:-1], wh, a["w_sorted"],
                                  a["rowptr"], "relu")


# -- the CSR-row kernels (atom_readout, band_agg, band_bwd, band_rev_bwd) -----

CSR_KERNELS = ["atom_readout", "band_agg", "band_bwd", "band_rev_bwd"]


def _long_runs(H, dev):
    """A synthetic CSR: atom 0 empty, then runs of every length 0..40 in a
    shuffled order (820 real rows), 37 padding rows, fractional weights; m
    not zero on padding rows; srev an involution over the real rows that
    maps every padding row to itself."""
    rng = np.random.default_rng(4)
    counts = np.concatenate([[0], rng.permutation(41)])
    rowptr = np.zeros(counts.shape[0] + 1, np.int32)
    np.cumsum(counts, out=rowptr[1:])
    n_real = int(rowptr[-1])
    B = n_real + 37
    w = np.zeros(B, np.float32)
    w[:n_real] = rng.uniform(0.05, 1.0, n_real)
    m = rng.normal(size=(B, H)).astype(np.float32)
    pairs = rng.permutation(n_real).reshape(-1, 2)
    srev = np.arange(B, dtype=np.int32)
    srev[pairs[:, 0]], srev[pairs[:, 1]] = pairs[:, 1], pairs[:, 0]
    T = lambda x: torch.as_tensor(x, device=dev)
    return T(m), T(w), T(rowptr), T(srev), n_real


def _csr_call(kernel, fn, x, ws, srev, rp):
    """``fn`` (the wrapper or its plain version) with ``kernel``'s
    arguments: band_rev_bwd also takes srev."""
    if kernel == "band_rev_bwd":
        return fn(x, ws, srev, rp)
    return fn(x, ws, rp)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [4, 37, 300, 333])
def test_csr_kernels_on_runs_up_to_40(cuda, H):
    """The four kernels against their plain versions on runs of 0 to 40
    rows (the unrolled groups and the loop over them; one float a thread
    at H = 37 and 333), atom 0 exactly 0, padding rows of z and dm exactly
    -m (band_rev_bwd: -m[srev])."""
    m, w, rp, srev, n_real = _long_runs(H, cuda)
    out = {}
    for kernel in CSR_KERNELS:
        out[kernel] = _csr_call(kernel, getattr(band_mpnn, kernel), m, w,
                                srev, rp)
        _close(out[kernel], _csr_call(
            kernel, getattr(band_mpnn, f"{kernel}_plain"), m, w, srev, rp))
    assert (out["atom_readout"][0] == 0).all()
    assert torch.equal(out["band_agg"][n_real:], -m[n_real:])
    assert torch.equal(out["band_bwd"][n_real:], -m[n_real:])
    assert torch.equal(out["band_rev_bwd"][n_real:],
                       -m[srev[n_real:].long()])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 300, 333, 1495])
def test_csr_kernels_equal_the_fp32_stage_z_bit_for_bit(cuda, kind, H):
    """band_agg's z is band_matmul's FP32 z, and atom_readout composed with
    a[src] - m[srev] is band_rev_layer's FP32 z on real rows: the same
    fmaf chain in CSR order."""
    m, inp, _, wh, a, n_real = _plain_band_operands(kind, H, cuda)
    ws, rp = a["w_sorted"], a["rowptr"]
    z = band_mpnn.band_agg(m, ws, rp)
    z_f32 = band_mpnn.band_matmul_forward(m, wh, ws, rp, "highest")[1]
    torch.cuda.synchronize()
    assert torch.equal(z, z_f32)
    idx = (ws, a["src_sorted"], a["srev"], rp)
    z_rev = band_mpnn.band_rev_layer_forward(m, inp, wh, *idx, "relu", True,
                                             "highest")[1]
    atoms = band_mpnn.atom_readout(m, ws, rp)
    got = atoms[a["src_sorted"].long()] - m[a["srev"].long()]
    torch.cuda.synchronize()
    assert torch.equal(got[:n_real], z_rev[:n_real])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [32, 300, 333])
def test_bwd_kernels_with_unit_weights_equal_the_readout_bit_for_bit(
        cuda, kind, H):
    """With unit weights ``band_bwd(g)[c] = G[dst c] - g[c]`` and
    ``band_rev_bwd(g)[c] = S[dst c] - g[srev c]``, with G and S the atom
    readout of g and of g[srev]: the same sum from 0 in CSR order, and
    fmaf(1, G, -x) is G - x. Real rows, torch.equal."""
    _, _, g, _, a, n_real = _plain_band_operands(kind, H, cuda)
    rp, srev = a["rowptr"], a["srev"]
    ones = torch.ones_like(a["w_sorted"])
    dst = torch.repeat_interleave(
        torch.arange(rp.shape[0] - 1, device=cuda), rp[1:] - rp[:-1])
    g_rev = g[srev.long()]
    dm = band_mpnn.band_bwd(g, ones, rp)
    dm_rev = band_mpnn.band_rev_bwd(g, ones, srev, rp)
    want = band_mpnn.atom_readout(g, ones, rp)[dst] - g[:n_real]
    want_rev = (band_mpnn.atom_readout(g_rev, ones, rp)[dst]
                - g_rev[:n_real])
    torch.cuda.synchronize()
    assert torch.equal(dm[:n_real], want)
    assert torch.equal(dm_rev[:n_real], want_rev)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", CSR_KERNELS)
def test_csr_kernels_take_one_float_a_thread_on_misaligned_rows(cuda,
                                                                kernel):
    """m as a view 4 bytes past a 16-byte boundary: the C entry takes the
    one-float path (the 16-byte one would fault on it) and gives the
    aligned result bit for bit."""
    m, _, _, _, a, _ = _plain_band_operands("polymer", 300, cuda)
    ws, srev, rp = a["w_sorted"], a["srev"], a["rowptr"]
    flat = torch.empty(m.numel() + 1, device=cuda)
    view = flat[1:].view(m.shape)
    view.copy_(m)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    fn = getattr(band_mpnn, kernel)
    plain = getattr(band_mpnn, f"{kernel}_plain")
    got = _csr_call(kernel, fn, view, ws, srev, rp)
    _close(got, _csr_call(kernel, plain, m, ws, srev, rp))
    assert torch.equal(got, _csr_call(kernel, fn, m, ws, srev, rp))


# -- the tensor-core stage of band_matmul_act / band_matmul -------------------

TC_WIDTHS = [37, 300, 1495]        # ragged in K and N, the default, widest
# |act(a) - act(b)| <= slope |a - b|: selu's steepest slope is scale x alpha
ACT_SLOPE = {"relu": 1.0, "leakyrelu": 1.0, "prelu": 1.0, "tanh": 1.0,
             "elu": 1.0, "selu": 1.0507009873554805 * 1.6732632423543772}


def _tc_product_refs(z, z_plain, wh, precision, inp=None):
    """``[inp +] z @ W_h`` at ``precision`` in PyTorch on the kernel's z
    and, at "high", on the plain z. At "default" z is rounded to bfloat16
    once: where two float32 sums of an entry differ in the last place
    across a rounding boundary, z_hi moves by a whole bfloat16 step, so
    only the kernel's own z (the FP32 stage's, bit for bit) is a fair
    operand; "high" carries that remainder in z_lo."""
    zs = [z] + ([z_plain] if precision == "high" else [])
    return [band_mpnn.band_product(x, wh, precision)
            + (0 if inp is None else inp) for x in zs]


def _close_act(got, want, pre, act):
    """The layer's output against the plain one, with the kernel tolerance
    of the pre-activation (what the tensor cores sum) carried through the
    activation: tanh and selu squeeze large pre-activations to about 1,
    their error where the pre-activation is small is that of the sums."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = ACT_SLOPE[act] * (1e-5 * pre.abs().max().item() + 1e-6)
    assert err <= tol, (err, tol)


def _tc_delta(fn, *args):
    """Launch counts and tensor-core launch counts that ``fn`` adds."""
    before = band_mpnn.launch_counts(), band_mpnn.tc_launch_counts()
    out = fn(*args)
    after = band_mpnn.launch_counts(), band_mpnn.tc_launch_counts()
    delta = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
             for a, b in zip(after, before)]
    return out, delta


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("H", TC_WIDTHS)
@pytest.mark.parametrize("form", ["matmul", "rev"])
def test_tc_stage_is_exact_on_structured_inputs(cuda, form, H, precision):
    """Small integers in m, unit weights and a permutation for W_h: every
    operand and product is exact in bf16, so the kernel must give the
    plain value bit for bit; a wrong swizzle, descriptor or fragment map
    moves whole rows or columns. ``form``: ``band_matmul`` and
    ``band_matmul_act``, or ``band_rev_layer``."""
    m, inp, _, _, a, n_real = _plain_band_operands("molecules", H, cuda)
    B = m.shape[0]
    t = torch.arange(B, device=cuda)[:, None]
    k = torch.arange(H, device=cuda)[None, :]
    m = ((t % 7) + 3 * (k % 5) - 8 + (k // 64) % 3).float()
    ones = torch.ones_like(a["w_sorted"])
    perm = torch.randperm(H, generator=torch.Generator().manual_seed(H))
    wh = torch.eye(H, device=cuda)[perm.to(cuda)]
    if form == "rev":
        idx = (ones, a["src_sorted"], a["srev"], a["rowptr"])
        (out, z), launches = _tc_delta(band_mpnn.band_rev_layer_forward, m,
                                       inp, wh, *idx, "relu", True,
                                       precision)
        assert launches == [{"band_rev_layer": 1}, {"band_rev_layer": 1}]
        want_z = band_mpnn.band_rev_z_plain(m, *idx)
        torch.cuda.synchronize()
        assert torch.equal(z, want_z)
        assert torch.equal(out, torch.relu(inp + want_z @ wh))
        return
    (out, z), launches = _tc_delta(band_mpnn.band_matmul_forward, m, wh, ones,
                                   a["rowptr"], precision)
    assert launches == [{"band_matmul": 1}, {"band_matmul": 1}]
    want_z = band_mpnn.band_agg_plain(m, ones, a["rowptr"])
    torch.cuda.synchronize()
    assert torch.equal(z, want_z)
    assert torch.equal(out, want_z @ wh)
    out_act, _ = band_mpnn.band_matmul_act_forward(
        m, inp, wh, ones, a["rowptr"], "relu", False, precision)
    torch.cuda.synchronize()
    assert torch.equal(out_act, torch.relu(inp + want_z @ wh))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", TC_WIDTHS)
def test_tc_band_matmul_act_matches_plain(cuda, H, kind, precision):
    m, inp, _, wh, a, n_real = _plain_band_operands(kind, H, cuda)
    from polymer_chemprop_tpu_torch.models.nn import get_activation
    idx = (a["w_sorted"], a["rowptr"])
    z_plain = band_mpnn.band_agg_plain(m, *idx)
    for act in ("relu", "tanh", "selu"):
        args = (m, inp, wh, *idx, act)
        (out, z), launches = _tc_delta(band_mpnn.band_matmul_act_forward,
                                       *args, True, precision)
        assert launches == [{"band_matmul_act": 1}, {"band_matmul_act": 1}]
        out_only, none = band_mpnn.band_matmul_act_forward(*args, False,
                                                           precision)
        assert none is None
        # the plain product on the kernel's own z and, at "high", on the
        # plain z (_tc_product_refs)
        for pre in _tc_product_refs(z, z_plain, wh, precision, inp):
            want = get_activation(act)(pre)
            _close_act(out, want, pre, act)
            if act == "relu":
                _close(out, want)
        torch.cuda.synchronize()
        assert torch.equal(out, out_only)
        # z is the FP32 stage's z, bit for bit
        assert torch.equal(z, band_mpnn.band_matmul_act_forward(
            *args, True, "highest")[1])
        _close(z, z_plain)
        assert torch.equal(z[n_real:], -m[n_real:])


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", TC_WIDTHS)
def test_tc_band_matmul_matches_plain_and_fp64(cuda, H, kind, precision):
    m, _, _, wh, a, n_real = _plain_band_operands(kind, H, cuda)
    idx = (a["w_sorted"], a["rowptr"])
    (out, z), launches = _tc_delta(band_mpnn.band_matmul_forward, m, wh,
                                   *idx, precision)
    assert launches == [{"band_matmul": 1}, {"band_matmul": 1}]
    z_plain = band_mpnn.band_agg_plain(m, *idx)
    for want in _tc_product_refs(z, z_plain, wh, precision):
        _close(out, want)
    _close(z, z_plain)
    assert torch.equal(z[n_real:], -m[n_real:])
    exact = band_mpnn.band_agg_plain(m.double(), idx[0].double(),
                                     idx[1]) @ wh.double()
    err = ((out.double() - exact).abs().max() / exact.abs().max()).item()
    # the split's dropped lo x lo term: about 1e-5 at "high"; one bf16
    # pass keeps about 3 digits
    assert err <= (3e-5 if precision == "high" else 1e-2), err


def _straight_through(x, wh, precision):
    """``x @ W_h`` at ``precision`` in value, with the FP32 product's
    gradient: the reference for the Functions, whose backward is FP32 at
    every precision."""
    fp32 = x @ wh
    return fp32 + (band_mpnn.band_product(x.detach(), wh.detach(), precision)
                   - fp32.detach())


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_tc_function_gradients_match_autograd(cuda, kind, act):
    """At "high" the forward runs on the tensor cores and the backward is
    FP32 (band_bwd and two products), against PyTorch's autograd through
    the plain versions with the split product's value and the FP32
    product's gradient."""
    from polymer_chemprop_tpu_torch.models.nn import get_activation
    H = 300
    m, inp, g, wh, a, _ = _plain_band_operands(kind, H, cuda)
    idx = (a["w_sorted"], a["rowptr"])
    pre = inp + band_mpnn.band_agg_plain(m, *idx) @ wh
    inp = torch.where(pre.abs() < 1e-3,
                      inp + torch.where(pre >= 0, 2e-3, -2e-3), inp)
    rev = (a["w_sorted"], a["src_sorted"], a["srev"], a["rowptr"])
    pre_rev = inp + band_mpnn.band_rev_z_plain(m, *rev) @ wh
    inp_rev = torch.where(pre_rev.abs() < 1e-3,
                          inp + torch.where(pre_rev >= 0, 2e-3, -2e-3), inp)
    cases = [
        ((m, wh), lambda x, w: band_mpnn.band_matmul(x, w, *idx, "high"),
         lambda x, w: _straight_through(band_mpnn.band_agg_plain(x, *idx), w,
                                        "high"),
         {"band_matmul": 1, "band_bwd": 1}),
        ((m, wh, inp),
         lambda x, w, i: band_mpnn.band_matmul_act(x, i, w, *idx, act, "high"),
         lambda x, w, i: get_activation(act)(i + _straight_through(
             band_mpnn.band_agg_plain(x, *idx), w, "high")),
         {"band_matmul_act": 1, "band_bwd": 1}),
        ((m, wh, inp_rev),
         lambda x, w, i: band_mpnn.band_rev_layer(x, i, w, *rev, act, "high"),
         lambda x, w, i: get_activation(act)(i + _straight_through(
             band_mpnn.band_rev_z_plain(x, *rev), w, "high")),
         {"band_rev_layer": 1, "band_rev_bwd": 1}),
    ]
    for operands, fn, plain, launches in cases:
        def grads(f):
            leaves = [t.clone().requires_grad_(True) for t in operands]
            return torch.autograd.grad(f(*leaves), leaves, g)

        got, delta = _tc_delta(grads, fn)
        assert delta[0] == launches
        for a_, b_ in zip(got, grads(plain)):
            _close(a_, b_)


@pytest.mark.gpu
def test_tc_shared_memory_is_fixed_and_scratch_matches(cuda):
    from polymer_chemprop_tpu_torch.kernels.build import load
    lib = load("band_matmul")
    assert lib.band_matmul_tc_smem_bytes() == band_mpnn.TC_SMEM_BYTES
    assert band_mpnn.TC_SMEM_BYTES <= band_mpnn.SMEM_PER_BLOCK
    for H in (1, 37, 64, 65, 300, 304, 305, 1495, 1600):
        assert lib.band_matmul_tc_scratch_bytes(H) \
            == band_mpnn.tc_scratch_bytes(H)
    m, inp, _, wh, a, _ = _plain_band_operands("molecules", 32, cuda)
    with pytest.raises(ValueError, match="band_precision"):
        band_mpnn.band_matmul(m, wh, a["w_sorted"], a["rowptr"], "fp16")
    with pytest.raises(ValueError, match="band_precision"):
        band_mpnn.band_rev_layer(m, inp, wh, a["w_sorted"], a["src_sorted"],
                                 a["srev"], a["rowptr"], "relu", "fp16")


# -- the probes' kernels (band_ctrl, fused_matmul) ---------------------------

@pytest.fixture(scope="module")
def bench_b():
    """The bench batch's padded bond count (1,024 molecules: 28,032) and
    its bond weights, featurized once for the module."""
    from polymer_chemprop_tpu_torch.probes.bench_batch import (bench_aux,
                                                               bench_batch)
    gb = bench_batch(1024)
    return gb.f_bonds.shape[0], bench_aux(gb).w_sorted


def _ctrl_operands(B, H, w_sorted, weights, dev):
    rng = np.random.default_rng(2)
    T = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    w = w_sorted[:B] if w_sorted.shape[0] >= B else np.ones(B, np.float32)
    if weights == "polymer":
        w = np.where(w > 0, rng.choice([0.25, 0.5, 0.75], w.shape), 0.0)
    return (T(rng.normal(size=(B, H)).astype(np.float32)),
            T(rng.normal(size=(B, H)).astype(np.float32)),
            T((rng.normal(size=(H, H)) * 0.05).astype(np.float32)),
            T(w.astype(np.float32)))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["noq", "pure"])
@pytest.mark.parametrize("ranges", ["own rows", "512-row windows"])
@pytest.mark.parametrize("weights", ["unit", "polymer"])
@pytest.mark.parametrize("shape", ["bench", (1000, 300), (1000, 96),
                                   (1000, 1495)])
def test_band_ctrl_matches_plain(cuda, bench_b, shape, weights, ranges,
                                 mode):
    B, H = (bench_b[0], 300) if shape == "bench" else shape
    m, inp, wh, w = _ctrl_operands(B, H, bench_b[1], weights, cuda)
    if ranges == "own rows":
        lo, hi = probe_kernels.own_row_ranges(B, cuda)
    else:
        starts = np.minimum(np.arange(0, B, probe_kernels.TPU_TILE),
                            B - probe_kernels.TPU_WINDOW)
        lo, hi = probe_kernels.window_ranges(starts, B, cuda)
    before = probe_kernels.band_ctrl.launches
    got = probe_kernels.band_ctrl(m, inp if mode == "noq" else None, wh, w,
                                  lo, hi, mode)
    assert probe_kernels.band_ctrl.launches == before + 1
    _close(got, probe_kernels.band_ctrl_plain(m, inp, wh, w, lo, hi, mode))


@pytest.mark.gpu
def test_band_ctrl_without_weights_is_the_activation_of_inp(cuda):
    """With zero weights z is exactly 0, so out = act(inp) exactly."""
    B, H = 1000, 300
    m, inp, wh, _ = _ctrl_operands(B, H, np.ones(B, np.float32), "unit",
                                   cuda)
    lo, hi = probe_kernels.own_row_ranges(B, cuda)
    w = torch.zeros(B, device=cuda)
    got = probe_kernels.band_ctrl(m, inp, wh, w, lo, hi, "noq")
    torch.cuda.synchronize()
    assert torch.equal(got, torch.relu(inp))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["bench", (1000, 300), (1000, 96),
                                   (28672, 384), (77, 33),
                                   # (N, K, M): K != M, M over one column
                                   # pass of 304 and over two, K ragged and
                                   # deeper than one chunk of 64
                                   (1000, 300, 96), (1000, 96, 300),
                                   (1000, 300, 384), (77, 33, 610),
                                   (130, 700, 20)])
def test_fused_matmul_matches_plain(cuda, bench_b, shape):
    N, K, M = ((bench_b[0], 300, 300) if shape == "bench"
               else shape if len(shape) == 3 else (*shape, shape[1]))
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(N, K)).astype(np.float32),
                        device=cuda)
    w = torch.as_tensor((rng.normal(size=(K, M)) * 0.05).astype(np.float32),
                        device=cuda)
    b_hi, b_lo = probe_kernels.split_bf16(w)
    before = probe_kernels.fused_matmul.launches
    got = probe_kernels.fused_matmul(x, b_hi, b_lo)
    assert probe_kernels.fused_matmul.launches == before + 1
    assert got.shape == (N, M)
    _close(got, probe_kernels.fused_matmul_plain(x, b_hi, b_lo))
    # the split itself: within about 1e-5 of the float32 product
    exact = x.double() @ w.double()
    assert ((got.double() - exact).abs().max()
            <= 1e-4 * exact.abs().max()).item()


@pytest.mark.gpu
def test_probe_wrappers_reject_bad_inputs(cuda):
    B, H = 64, 32
    m, inp, wh, w = _ctrl_operands(B, H, np.ones(B, np.float32), "unit",
                                   cuda)
    lo, hi = probe_kernels.own_row_ranges(B, cuda)
    with pytest.raises(TypeError):
        probe_kernels.band_ctrl(m, inp, wh, w, lo.long(), hi, "noq")
    with pytest.raises(ValueError, match="shape"):
        probe_kernels.band_ctrl(m, inp, wh, w, lo[:1], hi[:1], "noq")
    with pytest.raises(ValueError, match="needs inp"):
        probe_kernels.band_ctrl(m, None, wh, w, lo, hi, "noq")
    b_hi, b_lo = probe_kernels.split_bf16(wh)
    with pytest.raises(TypeError):
        probe_kernels.fused_matmul(m, b_hi.float(), b_lo)
    with pytest.raises(ValueError, match="shape"):
        probe_kernels.fused_matmul(m, b_hi[:-1], b_lo[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        probe_kernels.fused_matmul(m.t().contiguous().t(), b_hi, b_lo)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary: the FP32 stage's one-float path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["noq", "pure"])
@pytest.mark.parametrize("H", [300, 96, 1495])
def test_fp32_stage_paths_give_the_same_bits(cuda, H, mode):
    """The stage's float4 path (H % 4 == 0, aligned) and its one-float
    path (misaligned W_h) run the same fmaf chain: equal bits; at H = 1,495
    (five column passes) the one-float path against the plain version."""
    B = 1000
    m, inp, wh, w = _ctrl_operands(B, H, np.ones(B, np.float32), "unit",
                                   cuda)
    lo, hi = probe_kernels.own_row_ranges(B, cuda)
    got = probe_kernels.band_ctrl(m, inp, wh, w, lo, hi, mode)
    odd = probe_kernels.band_ctrl(m, inp, _misaligned(wh), w, lo, hi, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, odd)
    _close(got, probe_kernels.band_ctrl_plain(m, inp, wh, w, lo, hi, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_highest_layer_at_the_widest_fused_width(cuda, kind):
    """band_rev_layer and band_matmul_act at "highest" and H = 1,495 (the
    block's whole shared memory, five column passes, the one-float path)
    against their plain versions, with relu so that the output keeps the
    pre-activation's scale, and z bit for bit the CSR kernels'."""
    H = 1495
    m, inp, wh, a, n_real = _batch(kind, H, cuda)
    idx = (a["w_sorted"], a["src_sorted"], a["srev"], a["rowptr"])
    out, z = band_mpnn.band_rev_layer_forward(m, inp, wh, *idx, "relu", True,
                                              "highest")
    _close(out, band_mpnn.band_rev_layer_plain(m, inp, wh, *idx, "relu"))
    _close(z, band_mpnn.band_rev_z_plain(m, *idx))
    out, z = band_mpnn.band_matmul_act_forward(
        m, inp, wh, a["w_sorted"], a["rowptr"], "relu", True, "highest")
    _close(out, band_mpnn.band_matmul_act_plain(m, inp, wh, a["w_sorted"],
                                                a["rowptr"], "relu"))
    torch.cuda.synchronize()
    assert torch.equal(z, band_mpnn.band_agg(m, a["w_sorted"], a["rowptr"]))


@pytest.mark.gpu
def test_fused_matmul_scratch_matches_the_library(cuda):
    from polymer_chemprop_tpu_torch.kernels.build import load
    lib = load("fused_matmul")
    for K, M in ((300, 300), (384, 384), (300, 96), (33, 610), (1, 1),
                 (64, 304), (65, 305)):
        assert lib.fused_matmul_scratch_bytes(K, M) \
            == probe_kernels.fused_matmul_scratch_bytes(K, M)


# -- the gather entry of atom_readout.cu (atom_messages) ----------------------

GATHER_OPS = ["atom_neighbor_sum", "src_readout"]


def _atom_table(kind, H, dev):
    """An (A, H) table, an (A, H) cotangent and the batch's index tensors."""
    _, _, _, a, n_real = _batch(kind, 4, dev)
    A = a["rowptr"].shape[0] - 1
    gen = torch.Generator(dev).manual_seed(5)
    h, g = (torch.randn((A, H), device=dev, generator=gen) for _ in range(2))
    return h, g, a, n_real


def _gather_op(op, h, a):
    """(wrapper, plain version, composed form) of ``op`` on h: the
    composed form is the gather h[src_sorted] then atom_readout, what the
    JAX package computes."""
    w = (torch.ones_like(a["w_sorted"]) if op == "atom_neighbor_sum"
         else a["w_sorted"])
    src, rp = a["src_sorted"], a["rowptr"]
    wrapper = getattr(band_mpnn, f"{op}_sorted")
    plain = (band_mpnn.atom_neighbor_sum_plain(h, src, rp)
             if op == "atom_neighbor_sum"
             else band_mpnn.src_readout_plain(h, w, src, rp))
    composed = band_mpnn.atom_readout(h.index_select(0, src.long()), w, rp)
    return wrapper(h, a), plain, composed


@pytest.mark.gpu
@pytest.mark.parametrize("op", GATHER_OPS)
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [4, 37, 300, 333, 1600])
def test_atom_gather_matches_plain_and_composed(cuda, op, kind, H):
    """Against the plain version (kernel tolerance) and the composed form
    (bit for bit: the same fmaf chain over the same rows), one launch
    counted, atom 0 exactly 0; H = 37 and 333 take one float a thread."""
    h, _, a, _ = _atom_table(kind, H, cuda)
    wrapper = getattr(band_mpnn, f"{op}_sorted")
    before = wrapper.launches
    got, plain, composed = _gather_op(op, h, a)
    assert wrapper.launches == before + 1
    _close(got, plain)
    assert torch.equal(got, composed)
    assert (got[0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("op", GATHER_OPS)
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
@pytest.mark.parametrize("H", [37, 300])
def test_atom_gather_vjps_match_autograd_through_plain(cuda, op, kind, H):
    """The Functions' VJPs (the same kernel: the neighbour sum of g, the
    readout of g with w[srev]) against autograd through the plain
    versions; each backward is one more launch of the same wrapper."""
    h, g, a, _ = _atom_table(kind, H, cuda)
    wrapper = getattr(band_mpnn, f"{op}_sorted")

    def vjp(fn):
        x = h.clone().requires_grad_(True)
        return torch.autograd.grad(fn(x), x, g)[0]

    before = wrapper.launches
    got = vjp(lambda x: wrapper(x, a))
    assert wrapper.launches == before + 2
    src, rp = a["src_sorted"], a["rowptr"]
    want = vjp(lambda x: band_mpnn.atom_neighbor_sum_plain(x, src, rp)
               if op == "atom_neighbor_sum"
               else band_mpnn.src_readout_plain(x, a["w_sorted"], src, rp))
    _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("op", GATHER_OPS)
def test_atom_gather_one_float_on_misaligned_rows(cuda, op):
    """h as a view 4 bytes past a 16-byte boundary: the one-float path,
    bit for bit the aligned result."""
    h, _, a, _ = _atom_table("polymer", 300, cuda)
    flat = torch.empty(h.numel() + 1, device=cuda)
    view = flat[1:].view(h.shape)
    view.copy_(h)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    wrapper = getattr(band_mpnn, f"{op}_sorted")
    got = wrapper(view, a)
    torch.cuda.synchronize()
    assert torch.equal(got, wrapper(h, a))


@pytest.mark.gpu
@pytest.mark.parametrize("H", [4, 37, 300])
def test_atom_gather_on_runs_up_to_40(cuda, H):
    """The readout over the synthetic CSR of runs 0..40 rows with random
    source atoms and fractional weights: plain version and composed form."""
    m, w, rp, _, n_real = _long_runs(H, cuda)
    A = rp.shape[0] - 1
    gen = torch.Generator(cuda).manual_seed(6)
    src = torch.randint(1, A, (m.shape[0],), device=cuda, generator=gen,
                        dtype=torch.int32)
    h = m[:A].contiguous()
    aux = {"src_sorted": src, "w_sorted": w, "rowptr": rp,
           "srev": torch.arange(m.shape[0], device=cuda, dtype=torch.int32)}
    got = band_mpnn.src_readout_sorted(h, aux)
    _close(got, band_mpnn.src_readout_plain(h, w, src, rp))
    assert torch.equal(got, band_mpnn.atom_readout(
        h.index_select(0, src.long()), w, rp))


@pytest.mark.gpu
def test_atom_gather_rejects_bad_inputs(cuda):
    h, _, a, _ = _atom_table("molecules", 32, cuda)
    with pytest.raises(ValueError, match="shape"):
        band_mpnn.atom_neighbor_sum_sorted(h[:-1].contiguous(), a)
    with pytest.raises(TypeError):
        band_mpnn.src_readout_sorted(h, dict(a, src_sorted=a["src_sorted"]
                                             .long()))
    with pytest.raises(ValueError, match="contiguous"):
        band_mpnn.src_readout_sorted(h.t().contiguous().t(), a)


@pytest.mark.gpu
def test_csr_gather_sum_over_bond_rows(cuda):
    """The gather entry over a bond-row table (the edge-partitioned
    encoder's gather VJP, index srev, unit weights; and weighted): against
    its plain version, and bit for bit the readout of the gathered rows."""
    _, _, _, a, _ = _batch("molecules", 4, cuda)
    B = a["srev"].shape[0]
    gen = torch.Generator(cuda).manual_seed(6)
    g = torch.randn((B, 64), device=cuda, generator=gen)
    srev, rp, w = a["srev"], a["rowptr"], a["w_sorted"]
    before = band_mpnn.launch_counts()
    got = band_mpnn.csr_gather_sum(g, srev, None, rp)
    _close(got, band_mpnn.atom_neighbor_sum_plain(g, srev, rp))
    assert torch.equal(got, band_mpnn.atom_readout(
        g.index_select(0, srev.long()), torch.ones_like(w), rp))
    got = band_mpnn.csr_gather_sum(g, srev, w, rp)
    _close(got, band_mpnn.src_readout_plain(g, w, srev, rp))
    after = band_mpnn.launch_counts()
    assert after["atom_neighbor_sum_sorted"] \
        == before["atom_neighbor_sum_sorted"] + 1
    assert after["src_readout_sorted"] == before["src_readout_sorted"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("H", [37, 300, 1600])
def test_atom_gather_weights_through_an_index(cuda, H):
    """The gather entry with a weight index (3b's VJP reads w[srev]) on the
    runs of every length 0..40: bit for bit the same entry on the gathered
    weights and the composed form, and against the plain version."""
    m, w, rp, srev, _ = _long_runs(H, cuda)
    A = rp.shape[0] - 1
    gen = torch.Generator(cuda).manual_seed(7)
    src = torch.randint(1, A, (m.shape[0],), device=cuda, generator=gen,
                        dtype=torch.int32)
    h = m[:A].contiguous()
    launch = band_mpnn._atom_gather_launch
    got = launch("t", h, src, w, rp, widx=srev)
    w_rev = w[srev.long()]
    assert torch.equal(got, launch("t", h, src, w_rev, rp))
    assert torch.equal(got, band_mpnn.atom_readout(
        h.index_select(0, src.long()), w_rev, rp))
    _close(got, band_mpnn.src_readout_plain(h, w, src, rp, srev))


MOL_RUNS = (0, 1, 4, 5, 16, 17, 40)


def _molecule_csr(H, dev, seed=8):
    """A molecule CSR over shuffled atom rows: molecule 0 empty, then runs
    of MOL_RUNS twice and 30 of 8-20 atoms, shuffled; fractional weights
    with some 0; the host mean denominator; Xn-like scales."""
    from polymer_chemprop_tpu_torch.ops.sorted_aux import build_molecule_csr
    rng = np.random.default_rng(seed)
    counts = np.concatenate([MOL_RUNS, MOL_RUNS, rng.integers(8, 21, 30)])
    counts = np.concatenate([[0], rng.permutation(counts)])
    M, A = counts.shape[0], 1 + int(counts.sum()) + 5
    a2mol = np.zeros(A, np.int64)
    a2mol[1:1 + counts.sum()] = rng.permutation(np.repeat(np.arange(M),
                                                          counts))
    w = rng.uniform(0.05, 1.0, A).astype(np.float32)
    w[rng.random(A) < 0.1] = 0.0
    w[0] = w[1 + counts.sum():] = 0.0
    csr = build_molecule_csr(a2mol, w, M,
                             rows=np.arange(1, 1 + counts.sum()))
    T = lambda x: torch.as_tensor(x, device=dev)
    h = T(rng.normal(size=(A, H)).astype(np.float32))
    dop = T((1.0 + np.log10(rng.uniform(1, 100, M))).astype(np.float32))
    return h, T(w), T(a2mol), {k: T(v) for k, v in csr.items()}, dop


@pytest.mark.gpu
@pytest.mark.parametrize("aggregation", [None, "mean", "sum", "norm"])
@pytest.mark.parametrize("H", [37, 300, 1600])
def test_molecule_readout_on_runs_of_every_length(cuda, H, aggregation):
    """``molecule_readout_f32`` (or with no aggregation ``molecule_sum``,
    the gather entry with the weight index) on runs of 0, 1, 4, 5, 16, 17
    and 40 atoms (and 8-20): the sum bit for bit the composed form
    ``atom_readout(h[idx], w[idx])``, the aggregation bit for bit torch's
    ops on it, and within the kernel tolerance of the plain version; the
    empty molecule reads exactly 0; one launch, counted."""
    h, w, a2mol, aux, dop = _molecule_csr(H, cuda)
    idx, rp, denom = aux["mol_idx"], aux["mol_rowptr"], aux["mol_denom"]
    n = int(rp[-1])
    il = idx[:n].long()
    wsum = band_mpnn.atom_readout(h.index_select(0, il), w[il], rp)
    want = wsum if aggregation is None else band_mpnn.aggregate_molecules(
        wsum, denom, dop, aggregation, 30.0)
    plain = band_mpnn.molecule_readout_plain(h, w, idx, rp, denom, dop,
                                             aggregation, 30.0)
    before = band_mpnn.molecule_readout_sorted.launches
    if aggregation is None:
        got = band_mpnn.molecule_sum(h, w, a2mol, idx, rp)
    else:
        got = band_mpnn.molecule_readout_sorted(h, w, a2mol, aux, dop,
                                                aggregation, 30.0)
    assert band_mpnn.molecule_readout_sorted.launches == before + 1
    _close(got, plain)
    assert torch.equal(got, want)
    assert not got[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2])
def test_molecule_readout_on_misaligned_rows(cuda, offset):
    """h as a view 4 or 8 bytes past a 16-byte boundary (one float a
    thread): bit for bit the aligned result."""
    h, w, _, aux, dop = _molecule_csr(300, cuda)
    flat = torch.empty(h.numel() + offset, device=cuda)
    view = flat[offset:].view(h.shape)
    view.copy_(h)
    assert view.data_ptr() % 16 == 4 * offset
    args = (w, aux["mol_idx"], aux["mol_rowptr"], aux["mol_denom"], dop,
            "mean")
    got = band_mpnn._molecule_readout_launch(view, *args)
    assert torch.equal(got, band_mpnn._molecule_readout_launch(h, *args))


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["unit", "polymer"])
@pytest.mark.parametrize("aggregation", ["mean", "sum", "norm"])
def test_molecule_readout_and_vjp_equal_the_composition(cuda, aggregation,
                                                        weights):
    """``molecule_readout_sorted`` on a batch of copolymers (or molecules
    at unit weights): one launch counted in molecule_readout_sorted, and
    its output and VJP bit for bit the composed readout's
    (probes/readout_probe.py ``composed_readout``), within the kernel
    tolerance of ops/segment.py ``molecule_readout`` (index_add_)."""
    from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
    from polymer_chemprop_tpu_torch.ops import segment
    from polymer_chemprop_tpu_torch.probes.readout_probe import (
        composed_readout)
    polymer = weights == "polymer"
    gb = mol2graph(POLYMERS if polymer else SMILES,
                   FeaturizationConfig(polymer=polymer))
    t = batch_to_tensors(gb.arrays(sorted_aux=True), cuda)
    aux, a2mol, dop, w = (t["sorted_aux"], t["a2mol"], t["degree_of_polym"],
                          t["w_atoms"])
    A, M = a2mol.shape[0], dop.shape[0]
    gen = torch.Generator(cuda).manual_seed(9)
    h = torch.randn((A, 300), device=cuda, generator=gen)
    g = torch.randn((M, 300), device=cuda, generator=gen)
    x = h.clone().requires_grad_(True)
    before = band_mpnn.launch_counts()
    got = band_mpnn.molecule_readout_sorted(x, w, a2mol, aux, dop,
                                            aggregation)
    after = band_mpnn.launch_counts()
    assert after == dict(before, molecule_readout_sorted=before[
        "molecule_readout_sorted"] + 1)
    dh = torch.autograd.grad(got, x, g)[0]
    want, dh_want = composed_readout(h, w, a2mol, aux, dop, aggregation, g)
    assert torch.equal(got, want)
    assert torch.equal(dh, dh_want)
    _close(got, segment.molecule_readout(h, w, a2mol, M, dop, aggregation))


@pytest.mark.gpu
def test_molecule_readout_rejects_bad_inputs(cuda):
    from polymer_chemprop_tpu_torch.kernels.build import load
    h, w, _, aux, dop = _molecule_csr(32, cuda)
    args = (h, w, aux["mol_idx"], aux["mol_rowptr"], aux["mol_denom"], dop)
    out = torch.empty((dop.shape[0], 32), device=cuda)
    # an aggregation id the entry does not know: cudaErrorInvalidValue
    err = load("atom_readout").molecule_readout_f32(
        *(t.data_ptr() for t in (h, args[2], w) + args[3:]), out.data_ptr(),
        dop.shape[0], 32, 0, 1.0, torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0
    for aggregation in ("max", None):
        with pytest.raises(ValueError, match="aggregation"):
            band_mpnn._molecule_readout_launch(*args, aggregation)
    with pytest.raises(ValueError, match="shape"):
        band_mpnn._molecule_readout_launch(h, w[:-1].contiguous(),
                                           *args[2:], "sum")


@pytest.mark.gpu
@pytest.mark.parametrize("atom_messages", [False, True])
def test_model_with_features_and_descriptors_card_against_cpu(
        cuda, atom_messages):
    """A whole model with molecule features, atom descriptors (W_d) and
    extra bond features, forward and gradients, on the card against the
    same model on the CPU (its kernels' plain versions), at "highest":
    outputs rtol 1e-4, gradients 1e-4 of each gradient's largest entry.
    The kernels of the path must launch: rows 1-3 and the gather entry
    (the molecule readout), or with ``atom_messages`` the gather entry and
    row 3 (``f_sum``)."""
    from polymer_chemprop_tpu_torch.features import MolGraph, batch_graphs
    from polymer_chemprop_tpu_torch.chem import parse_smiles
    from polymer_chemprop_tpu_torch.models.encoder import (EncoderConfig,
                                                           batch_to_tensors)
    from polymer_chemprop_tpu_torch.models.init import init_model
    from polymer_chemprop_tpu_torch.models.model import (ModelConfig,
                                                         MoleculeModel)
    from polymer_chemprop_tpu_torch.train.step import make_loss_fn
    rng = np.random.default_rng(0)
    Eb, D, F, H = 2, 4, 7, 64
    graphs = [MolGraph(s, FeaturizationConfig(), bond_features_extra=rng.normal(
        size=(parse_smiles(s).n_bonds, Eb))) for s in SMILES]
    gb = batch_graphs(graphs, pad_mols=40)
    bond_fdim = (0 if atom_messages else 133) + 14 + Eb
    enc = EncoderConfig(atom_fdim=133, bond_fdim=bond_fdim, hidden_size=H,
                        atom_messages=atom_messages,
                        atom_descriptors="descriptor",
                        atom_descriptors_size=D, band_precision="highest")
    cfg = ModelConfig(encoder=enc, num_tasks=2, ffn_hidden_size=H,
                      features_size=F, use_input_features=True,
                      atom_descriptors="descriptor", atom_descriptors_size=D)
    model = init_model(MoleculeModel(cfg), torch.Generator().manual_seed(0))
    A = gb.f_atoms.shape[0]
    desc = np.zeros((A, D), np.float32)
    desc[1:gb.n_atoms_real] = rng.normal(size=(gb.n_atoms_real - 1, D))
    inputs = dict(features=rng.normal(size=(40, F)).astype(np.float32),
                  atom_descriptors=desc,
                  targets=rng.normal(size=(40, 2)).astype(np.float32),
                  mask=np.ones((40, 2), np.float32),
                  weights=np.ones((40, 1), np.float32))
    arrays = gb.arrays(sorted_aux=True)
    outs = []
    for dev in ("cpu", cuda):
        m = MoleculeModel(cfg).to(dev)
        m.load_state_dict(model.state_dict())
        batch = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
        batch["graphs"] = [batch_to_tensors(arrays, dev)]
        band_mpnn.reset_launch_counts()
        m.train()
        loss = make_loss_fn(cfg)(m, batch)
        loss.backward()
        m.eval()
        with torch.no_grad():
            preds = m(batch["graphs"], features=batch["features"],
                      atom_descriptors=batch["atom_descriptors"])
        counts = band_mpnn.launch_counts()
        grads = {n: p.grad.cpu() for n, p in m.named_parameters()}
        outs.append((preds.cpu(), loss.item(), grads, counts))
    (want, want_loss, want_grads, cpu_counts), (got, loss, grads, counts) = outs
    assert not any(cpu_counts.values())
    # the molecule readout on its own counter; atom_messages' f_sum on
    # atom_readout
    launched = ({"atom_neighbor_sum_sorted", "src_readout_sorted",
                 "atom_readout", "molecule_readout_sorted"} if atom_messages
                else {"band_rev_layer", "band_rev_bwd", "atom_readout",
                      "molecule_readout_sorted"})
    assert {k for k, v in counts.items() if v} == launched, counts
    assert "encoders.0.W_d.weight" in grads
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    for name, g in want_grads.items():
        err = (grads[name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-6, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("with_graph", [False, True])
def test_ssl_step_card_against_cpu(cuda, with_graph):
    """One masked SSL step (enhanced mode, gate open) on the card against
    the CPU, on the same draws and weights: loss and gradient norm within
    rtol 1e-4, each gradient within 1e-4 of its largest entry; rows 1-3
    and the molecule readout's gather entry launched, the layer on its
    FP32 entry."""
    from polymer_chemprop_tpu_torch import ssl
    from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
    fcfg = FeaturizationConfig(polymer=True)
    gb = mol2graph(POLYMERS, fcfg)
    arrays = gb.arrays(sorted_aux=True)
    cfg = ssl.SSLConfig(hidden_size=300, depth=3, use_enhanced_ssl=True,
                        augment_ratio=1.0)
    enc_cfg = ssl.ssl_encoder_config(cfg, fcfg)
    init = ssl.init_ssl_model(enc_cfg, 0)
    draws = ssl.draw_masks(torch.Generator().manual_seed(1),
                           gb.f_atoms.shape[0], gb.f_bonds.shape[0], True)
    labels = torch.linspace(-1, 1, gb.degree_of_polym.shape[0])
    outs = []
    for dev in ("cpu", cuda):
        model = ssl.SSLModel(enc_cfg).to(dev)
        model.load_state_dict(init.state_dict())
        step = ssl.make_ssl_step(cfg, model)
        band_mpnn.reset_launch_counts()
        loss, gnorm = step(batch_to_tensors(arrays, dev), labels.to(dev),
                           {k: v.to(dev) for k, v in draws.items()},
                           with_graph)
        outs.append((float(loss), float(gnorm),
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     band_mpnn.launch_counts(),
                     band_mpnn.tc_launch_counts()))
    (want_loss, want_gnorm, want, cpu_counts, _), \
        (loss, gnorm, got, counts, tc) = outs
    assert not any(cpu_counts.values())
    assert {k for k, v in counts.items() if v} == \
        {"band_rev_layer", "band_rev_bwd", "atom_readout",
         "molecule_readout_sorted"}, counts
    assert not any(tc.values()), tc
    np.testing.assert_allclose([loss, gnorm], [want_loss, want_gnorm],
                               rtol=1e-4)
    for name, g in want.items():
        err = (got[name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-6, (name, err)


# ---------------------------------------------------------------------------
# The sklearn baselines (baselines/): no kernel of their own, but every fit
# runs on the card; one seed grows the same forest and solves the same SVM
# problems there as on the CPU.
# ---------------------------------------------------------------------------

def _morgan_regression(n):
    import csv
    import os

    from polymer_chemprop_tpu_torch.features.generators import (
        morgan_binary_features_generator,
    )
    path = os.path.join(os.path.dirname(__file__), "data", "regression.csv")
    with open(path) as f:
        rows = list(csv.reader(f))[1:n + 1]
    X = np.stack([morgan_binary_features_generator(r[0]) for r in rows])
    return X, np.array([float(r[1]) for r in rows])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_sklearn_forest_card_against_cpu(cuda, kind):
    """Identical node arrays; predictions within 1e-9 relative."""
    from polymer_chemprop_tpu_torch.baselines import forest
    X, y = _morgan_regression(300)
    if kind == "classifier":
        y = (y > np.median(y)).astype(float)
        make = lambda dev: forest.RandomForestClassifier(  # noqa: E731
            20, random_state=0, class_weight="balanced_subsample",
            device=dev)
    else:
        make = lambda dev: forest.RandomForestRegressor(  # noqa: E731
            20, random_state=0, device=dev)
    card = make(cuda).fit(X[:250], y[:250])
    cpu = make("cpu").fit(X[:250], y[:250])
    assert all(t.device.type == "cuda" for t in card.tensors())
    for a, b in zip(card.tensors()[:4], cpu.tensors()[:4]):
        assert torch.equal(a.cpu(), b)
    predict = (lambda m: m.predict_proba(X[250:])) if kind == "classifier" \
        else (lambda m: m.predict(X[250:]))
    np.testing.assert_allclose(predict(card), predict(cpu), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["svr", "svc"])
def test_sklearn_svm_card_against_cpu(cuda, kind):
    """Decision values within 1e-6; the same iteration counts."""
    from polymer_chemprop_tpu_torch.baselines import svm
    X, y = _morgan_regression(300)
    if kind == "svc":
        y = (y > np.median(y)).astype(float)
        make = lambda dev: svm.SVC(probability=True, device=dev)  # noqa: E731
    else:
        make = lambda dev: svm.SVR(device=dev)  # noqa: E731
    card = make(cuda).fit(X[:250], y[:250])
    cpu = make("cpu").fit(X[:250], y[:250])
    assert all(t.device.type == "cuda" for t in card.tensors())
    assert card.n_iter_ == cpu.n_iter_
    np.testing.assert_allclose(card.decision_values(X[250:]).cpu().numpy(),
                               cpu.decision_values(X[250:]).numpy(),
                               rtol=0, atol=1e-6)
    if kind == "svc":
        np.testing.assert_allclose(card.predict_proba(X[250:]),
                                   cpu.predict_proba(X[250:]), rtol=0,
                                   atol=1e-6)
