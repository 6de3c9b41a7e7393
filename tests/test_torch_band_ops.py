"""The port's plain-band ops vs the JAX package's Pallas kernels.

* the plain versions of the four kernels (``band_agg``, ``band_bwd``,
  ``band_matmul``, ``band_matmul_act``) against JAX ``_band_apply``,
  ``_band_bwd_apply``, ``band_matmul_step_sorted`` and
  ``band_matmul_act_step_sorted``, whose Pallas kernels run in interpret
  mode at ``Precision.HIGHEST`` (as tests/test_pallas.py runs them on the
  CPU);
* the backward of the three ``torch.autograd.Function``s and of
  ``permute_rows`` against ``jax.grad`` through the JAX ops' ``custom_vjp``s;
* padding rows: ``z = -m`` and ``dm = -g`` exactly, and no real row reads
  one;
* the shape arithmetic that picks the layer form.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py.

Inputs are made with numpy from a seed and fed to both. Hidden 32 (lane
padded to 128 on the JAX side), 512 padded bonds. Tolerance: forward rtol
1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-5 (FP32 on both sides, sums
taken in another order, one more product in the backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.ops import pallas_mpnn as jpm
from polymer_chemprop_tpu_torch.features import FeaturizationConfig
from polymer_chemprop_tpu_torch.features import mol2graph
from polymer_chemprop_tpu_torch.models.encoder import EncoderConfig
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from polymer_chemprop_tpu_torch.ops import segment
from polymer_chemprop_tpu_torch.ops.sorted_aux import build_sorted_aux
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-5
H, HP = 32, 128
HIGHEST = jax.lax.Precision.HIGHEST
ACTS = ["relu", "leakyrelu", "prelu", "tanh", "elu", "selu"]
SMILES = ["CCO", "c1ccccc1", "CC(C)=CCCC(C)=CC(=O)", "C",
          "CCOc1ccc2nc(S(N)(=O)=O)sc2c1",
          "OCC3OC(OCC2OC(OC(C#N)c1ccccc1)C(O)C(O)C2O)C(O)C(O)C3O"]
POLYMERS = ["[*:1]CC[*:2].[*:3]CO[*:4]|0.5|0.5|<1-3:0.5:0.5<2-4:0.5:0.5~20",
            "[*:1]c1ccc([*:2])cc1.[*:3]C(C)C[*:4]|0.25|0.75|"
            "<1-3:0.25:0.75<2-4:0.75:0.25~100",
            "[*:1]CC[*:2].[*:3]c1ccc([*:4])cc1C|0.75|0.25|"
            "<1-3:0.5:0.5<2-4:0.5:0.5~7"]
# high-degree atoms: runs of up to 6 incoming bonds (S in SF6)
HUBS = ["FS(F)(F)(F)(F)F", "CC(C)(C)C", "OP(=O)(O)O"] * 4
KINDS = ["molecules", "polymer"]


@pytest.fixture(scope="module")
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


class Case:
    """One featurized batch in both layouts, with seeded operands that are
    NOT zero on padding rows (a bias makes the encoder's so)."""

    def __init__(self, kind, seed=0):
        polymer = kind == "polymer"
        smiles = {"molecules": SMILES, "polymer": POLYMERS, "hubs": HUBS}
        gb = mol2graph(smiles[kind], FeaturizationConfig(polymer=polymer),
                       pad_atoms=256, pad_bonds=512,
                       pad_mols=max(8, len(smiles[kind])))
        w = gb.w_bonds
        rng = np.random.default_rng(seed)
        if kind != "molecules":
            # untidy (non-bf16-exact) weights on top of the featurized ones
            w = np.where(w > 0, w * rng.uniform(0.3, 1.0, w.shape), 0.0
                         ).astype(np.float32)
        self.gb, self.w = gb, w
        self.A, self.B = gb.f_atoms.shape[0], gb.f_bonds.shape[0]
        aux = build_sorted_aux(gb.b2dst, gb.b2revb, w, num_atoms=self.A)
        jaux = jpm.build_sorted_aux(gb.b2dst, gb.b2revb, w, num_atoms=self.A)
        self.aux = aux
        self.n_real = int(aux.rowptr[-1])
        assert 0 < self.n_real < self.B
        self.t = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in aux._asdict().items()}
        self.j = {k: jnp.asarray(v) for k, v in jaux._asdict().items()
                  if v is not None}
        self.m = rng.normal(size=(self.B, H)).astype(np.float32)
        self.inp = rng.normal(size=(self.B, H)).astype(np.float32)
        self.g = rng.normal(size=(self.B, H)).astype(np.float32)
        self.wh = (rng.normal(size=(H, H)) * 0.2).astype(np.float32)

    def idx(self):
        return self.t["w_sorted"], self.t["rowptr"]


def _pad(x):
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, HP - x.shape[1])))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kind", KINDS + ["hubs"])
def test_band_agg_plain_matches_jax_kernel(interpret_mode, kind):
    c = Case(kind)
    want = np.asarray(jpm._band_apply(_pad(c.m), c.j["w_sorted"],
                                      c.j["dst_sorted"], c.j["rs"], HIGHEST))
    assert (want[:, H:] == 0).all()
    before = bm.launch_counts()
    got = bm.band_agg(torch.from_numpy(c.m), *c.idx()).numpy()
    assert bm.launch_counts() == before          # CPU: the plain version
    _close(got, want[:, :H])
    _close(bm.band_agg_plain(torch.from_numpy(c.m), *c.idx()), got, 0, 0)
    # padding rows lie in no run and carry weight 0: z = -m, bit for bit
    np.testing.assert_array_equal(got[c.n_real:], -c.m[c.n_real:])
    np.testing.assert_array_equal(want[c.n_real:, :H], -c.m[c.n_real:])


@pytest.mark.parametrize("kind", KINDS)
def test_band_bwd_plain_matches_jax_kernel(interpret_mode, kind):
    c = Case(kind)
    want = np.asarray(jpm._band_bwd_apply(_pad(c.g), c.j["w_sorted"],
                                          c.j["dst_sorted"], c.j["rs"],
                                          HIGHEST))
    before = bm.launch_counts()
    got = bm.band_bwd(torch.from_numpy(c.g), *c.idx()).numpy()
    assert bm.launch_counts() == before
    _close(got, want[:, :H])
    np.testing.assert_array_equal(got[c.n_real:], -c.g[c.n_real:])
    # unit weights inside the sum, the row's own weight outside: on
    # weighted data this is not the rev-fused layer's VJP
    if kind == "polymer":
        other = bm.band_rev_bwd(torch.from_numpy(c.g), c.t["w_sorted"],
                                c.t["srev"], c.t["rowptr"]).numpy()
        assert np.abs(other - got)[:c.n_real].max() > 0.1


def _long_run_csr(H):
    """A synthetic CSR: atom 0 empty, then runs of every length 0..40 in a
    shuffled order (820 real rows), 37 padding rows, fractional weights,
    a cotangent g not zero on padding rows, and an involution srev over
    the real rows that maps every padding row to itself."""
    rng = np.random.default_rng(4)
    counts = np.concatenate([[0], rng.permutation(41)])
    rowptr = np.zeros(counts.shape[0] + 1, np.int32)
    np.cumsum(counts, out=rowptr[1:])
    n_real = int(rowptr[-1])
    B = n_real + 37
    w = np.zeros(B, np.float32)
    w[:n_real] = rng.uniform(0.05, 1.0, n_real)
    g = rng.normal(size=(B, H)).astype(np.float32)
    pairs = rng.permutation(n_real).reshape(-1, 2)
    srev = np.arange(B, dtype=np.int32)
    srev[pairs[:, 0]], srev[pairs[:, 1]] = pairs[:, 1], pairs[:, 0]
    return g, w, rowptr, srev, n_real


def _bwd_by_definition(kernel, g, w, rowptr, srev):
    """dm in float64, written out as the headers of csrc/band_bwd.cu and
    csrc/band_rev_bwd.cu define it, one row at a time."""
    x = g.astype(np.float64)
    rows = np.arange(g.shape[0]) if kernel == "band_bwd" else srev
    dm = -x[rows]                        # padding rows, weight 0
    for v in range(rowptr.shape[0] - 1):
        run = range(rowptr[v], rowptr[v + 1])
        total = sum((x[rows[c]] for c in run), np.zeros(g.shape[1]))
        for c in run:
            dm[c] = w[c] * total - x[rows[c]]
    return dm


@pytest.mark.parametrize("H", [4, 37])
@pytest.mark.parametrize("kernel", ["band_bwd", "band_rev_bwd"])
def test_bwd_plain_versions_match_their_definition_on_runs_up_to_40(kernel,
                                                                    H):
    """band_bwd_plain and band_rev_bwd_plain against a float64 loop on
    runs of 0 to 40 rows, fractional weights and padding rows. Tolerance:
    1e-6 of the largest entry (FP32 sums of up to 40 rows); padding rows
    exactly -g (or -g[srev])."""
    g, w, rowptr, srev, n_real = _long_run_csr(H)
    T = torch.from_numpy
    if kernel == "band_bwd":
        got = bm.band_bwd_plain(T(g), T(w), T(rowptr)).numpy()
    else:
        got = bm.band_rev_bwd_plain(T(g), T(w), T(srev), T(rowptr)).numpy()
    want = _bwd_by_definition(kernel, g, w, rowptr, srev)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(got[n_real:], want[n_real:])


@pytest.mark.parametrize("kind", KINDS)
def test_band_message_step_sorted_matches_jax_and_natural_order(
        interpret_mode, kind):
    c = Case(kind)
    want = np.asarray(jpm.band_message_step_sorted(_pad(c.m), c.j, HIGHEST))
    got = bm.band_message_step_sorted(torch.from_numpy(c.m), c.t).numpy()
    _close(got, want[:, :H])
    # and the natural-order oracle (ops/segment.py) on the real rows
    perm = c.aux.perm
    nat = np.zeros_like(c.m)
    nat[perm] = c.m
    T = torch.from_numpy
    oracle = segment.bond_message_step(
        T(nat), T(c.w), T(c.gb.b2a), T(c.gb.b2dst), T(c.gb.b2revb), c.A
    ).numpy()[perm]
    _close(got[:c.n_real], oracle[:c.n_real])


@pytest.mark.parametrize("kind", KINDS)
def test_band_matmul_step_sorted_matches_jax_kernel(interpret_mode, kind):
    c = Case(kind)
    want = np.asarray(jpm.band_matmul_step_sorted(
        _pad(c.m), jnp.asarray(c.wh), c.j, HIGHEST))
    assert (want[:, H:] == 0).all()
    before = bm.launch_counts()
    got = bm.band_matmul_step_sorted(torch.from_numpy(c.m),
                                     torch.from_numpy(c.wh), c.t).numpy()
    assert bm.launch_counts() == before
    _close(got, want[:, :H])
    # both outputs of the wrapper: the product and z itself
    out, z = bm.band_matmul_forward(torch.from_numpy(c.m),
                                    torch.from_numpy(c.wh), *c.idx())
    _close(z, bm.band_agg_plain(torch.from_numpy(c.m), *c.idx()), 0, 0)
    _close(out[c.t["srev"].long()], got, 0, 0)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("kind", KINDS)
def test_band_matmul_act_step_sorted_matches_jax_kernel(interpret_mode, kind,
                                                        act):
    c = Case(kind, seed=len(act))
    inp_srev = c.inp[c.aux.srev]
    want = np.asarray(jpm.band_matmul_act_step_sorted(
        _pad(c.m), jnp.asarray(c.wh), _pad(inp_srev), c.j, act, HIGHEST))
    assert (want[:, H:] == 0).all()
    before = bm.launch_counts()
    got = bm.band_matmul_act_step_sorted(
        torch.from_numpy(c.m), torch.from_numpy(c.wh),
        torch.from_numpy(inp_srev), c.t, act).numpy()
    assert bm.launch_counts() == before
    _close(got, want[:, :H])
    # the identity the fused form rests on: act(inputs + (z @ W_h)[srev])
    sep = bm.band_message_step_sorted(torch.from_numpy(c.m), c.t) \
        @ torch.from_numpy(c.wh)
    from polymer_chemprop_tpu_torch.models.nn import get_activation
    _close(got, get_activation(act)(torch.from_numpy(c.inp) + sep))


def test_band_matmul_act_forward_writes_z_only_when_asked():
    c = Case("polymer")
    args = (torch.from_numpy(c.m), torch.from_numpy(c.inp),
            torch.from_numpy(c.wh), *c.idx(), "tanh")
    out, z = bm.band_matmul_act_forward(*args, want_z=True)
    out_only, none = bm.band_matmul_act_forward(*args, want_z=False)
    assert none is None and torch.equal(out, out_only)
    _close(z, bm.band_agg_plain(torch.from_numpy(c.m), *c.idx()), 0, 0)
    with pytest.raises(ValueError, match="not supported"):
        bm.band_matmul_act_forward(*args[:-1], "gelu", want_z=False)


# -- the Functions' backward against jax.grad --------------------------------

def _torch_grads(fn, *operands, cotangent):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in operands]
    out = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(
        out, leaves, torch.from_numpy(cotangent))]


def _jax_grads(fn, *operands, cotangent):
    """Gradients of sum(fn(...)[:, :H] * cotangent) in the operands, each
    cut back to its real width."""
    def loss(*ops):
        return (fn(*ops)[:, :H] * jnp.asarray(cotangent)).sum()
    padded = [_pad(x) if x.shape[0] != H else jnp.asarray(x)
              for x in operands]
    grads = jax.grad(loss, argnums=tuple(range(len(operands))))(*padded)
    return [np.asarray(g)[:, :H] for g in grads]


@pytest.mark.parametrize("kind", KINDS)
def test_band_agg_backward_matches_jax_grad(interpret_mode, kind):
    c = Case(kind)
    want, = _jax_grads(
        lambda m: jpm.band_message_step_sorted(m, c.j, HIGHEST), c.m,
        cotangent=c.g)
    got, = _torch_grads(lambda m: bm.band_message_step_sorted(m, c.t), c.m,
                        cotangent=c.g)
    _close(got, want, G_RTOL, G_ATOL)
    # the Function's backward is band_bwd itself
    direct, = _torch_grads(lambda m: bm.band_agg(m, *c.idx()), c.m,
                           cotangent=c.g)
    _close(direct, bm.band_bwd(torch.from_numpy(c.g), *c.idx()), 0, 0)


@pytest.mark.parametrize("kind", KINDS)
def test_band_matmul_backward_matches_jax_grad(interpret_mode, kind):
    c = Case(kind)
    want = _jax_grads(
        lambda m, w: jpm.band_matmul_step_sorted(m, w, c.j, HIGHEST),
        c.m, c.wh, cotangent=c.g)
    got = _torch_grads(lambda m, w: bm.band_matmul_step_sorted(m, w, c.t),
                       c.m, c.wh, cotangent=c.g)
    for g, w in zip(got, want):
        _close(g, w, G_RTOL, G_ATOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("act", ["relu", "tanh", "selu"])
@pytest.mark.parametrize("kind", KINDS)
def test_band_matmul_act_backward_matches_jax_grad(interpret_mode, kind, act):
    c = Case(kind, seed=len(act))
    inp_srev = c.inp[c.aux.srev]
    want = _jax_grads(
        lambda m, w, i: jpm.band_matmul_act_step_sorted(m, w, i, c.j, act,
                                                        HIGHEST),
        c.m, c.wh, inp_srev, cotangent=c.g)
    got = _torch_grads(
        lambda m, w, i: bm.band_matmul_act_step_sorted(m, w, i, c.t, act),
        c.m, c.wh, inp_srev, cotangent=c.g)
    for g, w in zip(got, want):
        _close(g, w, G_RTOL, G_ATOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("kind", KINDS)
def test_functions_backward_matches_autograd_through_plain(kind):
    """The three hand-written backwards against PyTorch's own autograd
    through the plain versions: the same check chip_smoke.py makes on the
    card."""
    c = Case(kind)
    idx = c.idx()
    pairs = [
        (lambda m, w, i: bm.band_agg(m, *idx) + 0 * (w.sum() + i.sum()),
         lambda m, w, i: bm.band_agg_plain(m, *idx) + 0 * (w.sum() + i.sum())),
        (lambda m, w, i: bm.band_matmul(m, w, *idx) + 0 * i.sum(),
         lambda m, w, i: bm.band_matmul_plain(m, w, *idx)[0] + 0 * i.sum()),
        (lambda m, w, i: bm.band_matmul_act(m, i, w, *idx, "elu"),
         lambda m, w, i: bm.band_matmul_act_plain(m, i, w, *idx, "elu")),
    ]
    for fn, plain in pairs:
        got = _torch_grads(fn, c.m, c.wh, c.inp, cotangent=c.g)
        want = _torch_grads(plain, c.m, c.wh, c.inp, cotangent=c.g)
        for g, w in zip(got, want):
            _close(g, w, G_RTOL, G_ATOL * max(1.0, np.abs(w).max()))


def test_permute_rows_gathers_in_both_directions():
    rng = np.random.default_rng(0)
    perm = rng.permutation(40).astype(np.int32)
    inv = np.argsort(perm).astype(np.int32)
    x = rng.normal(size=(40, 5)).astype(np.float32)
    g = rng.normal(size=(40, 5)).astype(np.float32)
    for dtype in (torch.int32, torch.int64):
        idx = torch.from_numpy(perm).to(dtype)
        inv_idx = torch.from_numpy(inv).to(dtype)
        leaf = torch.from_numpy(x).requires_grad_(True)
        out = bm.permute_rows(leaf, idx, inv_idx)
        np.testing.assert_array_equal(out.detach().numpy(), x[perm])
        dx, = torch.autograd.grad(out, leaf, torch.from_numpy(g))
        np.testing.assert_array_equal(dx.numpy(), g[inv])
        # what index_add_ (autograd's own backward of x[idx]) would give
        want, = jax.grad(lambda v: (v[jnp.asarray(perm)] * g).sum(),
                         argnums=(0,))(jnp.asarray(x))
        np.testing.assert_array_equal(dx.numpy(), np.asarray(want))


# -- padding rows -------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_padding_rows_reach_no_real_row(kind):
    """Whatever the padding rows of m and inp hold (with a bias they hold
    act(b)), no real row of any plain-band op and no atom of the readout
    changes, forward or backward."""
    c = Case(kind)
    n = c.n_real
    rng = np.random.default_rng(9)
    m2, inp2 = c.m.copy(), c.inp.copy()
    m2[n:] = 100.0 * rng.normal(size=m2[n:].shape)
    inp2[n:] = 100.0 * rng.normal(size=inp2[n:].shape)
    T = torch.from_numpy
    wh = T(c.wh)

    def outputs(m, inp):
        inp_srev = inp[c.t["srev"].long()]
        return [bm.band_message_step_sorted(m, c.t),
                bm.band_matmul_step_sorted(m, wh, c.t),
                bm.band_matmul_act_step_sorted(m, wh, inp_srev, c.t, "tanh")]

    for a, b in zip(outputs(T(c.m), T(c.inp)), outputs(T(m2), T(inp2))):
        assert torch.equal(a[:n], b[:n])
        assert not torch.equal(a[n:], b[n:])
    assert torch.equal(bm.atom_readout(T(c.m), *c.idx()),
                       bm.atom_readout(T(m2), *c.idx()))
    # backward: a cotangent on padding rows only moves no real row of dm
    g = np.zeros_like(c.g)
    g[n:] = c.g[n:]
    dm, = _torch_grads(lambda m: bm.band_message_step_sorted(m, c.t), c.m,
                       cotangent=g)
    assert (dm[:n] == 0).all()
    np.testing.assert_array_equal(dm[n:], -g[n:])


# -- the choice of layer form ---------------------------------------------------

def test_fused_layer_fits_mirrors_the_kernels_shared_memory():
    # csrc/band_tile.cuh: 4 * (ROWS * H + KS * NCHUNK + ROWS) bytes against
    # 227 KB
    assert bm.fused_layer_smem_bytes(300) == 4 * (32 * 300 + 32 * 320 + 32)
    assert bm.SMEM_PER_BLOCK == 232448
    assert bm.fused_layer_fits(300) and bm.fused_layer_fits(1495)
    assert not bm.fused_layer_fits(1496) and not bm.fused_layer_fits(2400)


@pytest.mark.parametrize("kw,form", [
    (dict(), "rev"),
    (dict(hidden_size=1495), "rev"),
    (dict(undirected=True), "matmul_act"),
    (dict(bias=True), "plain"),
    (dict(bias=True, undirected=True), "plain"),
    (dict(compute_dtype="bfloat16"), "plain"),
    (dict(hidden_size=1600), "plain"),
    (dict(hidden_size=1600, undirected=True), "plain"),
])
def test_layer_form_is_chosen_from_the_configuration(kw, form):
    cfg = EncoderConfig(atom_fdim=133, bond_fdim=147, **kw)
    cfg.check_supported()
    assert cfg.layer_form() == form


def test_fused_wrappers_refuse_a_width_that_does_not_fit():
    """The encoder never sends such a width to a fused kernel; a direct
    caller is told, not handed another path."""
    with pytest.raises(ValueError, match="shared memory"):
        bm._check_fits("band_matmul_act", 1600)
    bm._check_fits("band_matmul_act", 1495)
