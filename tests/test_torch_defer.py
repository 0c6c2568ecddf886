"""Port: the processor backward's ``defer_first`` form (the TPU backward's
deferred first layer, ``mgn_tpu/ops/fused.py:785-794``, ``:966-971``,
``:1071-1094``) on the CPU — K4's plain version without ``dvs``/``dvr``,
K8's plain version ``first_layer_adjoint_plain``, K6's ``N``-row
first-layer products — and the port's ``fused_process`` gradients against
``jax.grad`` of the JAX package's fused kernel in interpret mode with its
``_FORCE_DEFER`` pinned on and off.

The kernels themselves (K4's defer form, K8 and K6's mixed form) are held
against these plain versions on the card in ``tests/test_torch_kernels.py``
and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgn_tpu.ops.fused as JF
from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.ops.fused import build_fused_plan
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.train.common import param_leaves
from tests.torch_support import local_graph, one_thread  # noqa: F401  (fixture)

torch.set_num_threads(2)

N, E, MPS = 256, 512, 3
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


def _case(seed, latent, hidden, n=N, e=E):
    rng = np.random.default_rng(seed)
    s, r = local_graph(rng, n, e)
    cfg = JaxMGNConfig(node_input_dim=8, edge_input_dim=3, output_dim=2, latent_size=latent,
                       hidden_layers=hidden, message_passing_steps=MPS)
    proc = jax_init_mgn(jax.random.PRNGKey(seed), cfg)["processor"]
    v0 = rng.normal(size=(n, latent)).astype(np.float32)
    e0 = rng.normal(size=(e, latent)).astype(np.float32)
    ev = np.ones((e, 1), np.float32)
    row = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))]).astype(np.int32)
    sender_perm = np.argsort(s, kind="stable").astype(np.int32)
    sender_offsets = np.concatenate([[0], np.cumsum(np.bincount(s, minlength=n))]).astype(np.int32)
    cv = rng.normal(size=(n, latent)).astype(np.float32)
    return dict(proc=proc, s=s, r=r, v0=v0, e0=e0, ev=ev, row=row, n=n, cv=cv,
                perm=sender_perm, soff=sender_offsets,
                port=params_from_jax(jax.tree.map(np.asarray, proc)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pinned(defer, fn):
    """``fn()`` with both packages' deferred first layer pinned, the JAX
    kernel cache cleared around the call and the hooks restored, as
    tests/test_fused.py pins them.  The JAX forward's ``preproject`` form is
    pinned with it: the JAX backward recomputes the edge MLP pre-projected
    in its deferred form and in three parts otherwise, so only these pairs
    recompute the ReLU masks its forward applied (its own rules, E >= N for
    both, pair them too).  Pinned apart, a mask can flip: at seed 3, latent
    128, 3 hidden layers, the three-part backward after a pre-projected
    forward lies 2.4e-3 from the f64 witness, the port and the paired JAX
    forms within 7.3e-7."""
    JF._FORCE_PREPROJECT, JF._FORCE_DEFER, F._FORCE_DEFER = defer, defer, defer
    JF._make_fused.cache_clear()
    try:
        return fn()
    finally:
        JF._FORCE_PREPROJECT = JF._FORCE_DEFER = F._FORCE_DEFER = None
        JF._make_fused.cache_clear()


def _jax_grads(c, dtype):
    jdt = getattr(jnp, dtype)

    def loss(p, v, e_):
        plan = build_fused_plan(c["s"], c["r"], c["n"])
        out = JF.fused_process(p, v.astype(jdt), e_.astype(jdt), plan, jnp.asarray(c["s"]),
                               jnp.asarray(c["r"]), jnp.asarray(c["ev"]).astype(jdt), MPS,
                               interpret=True, kernel_bwd=True)
        return jnp.sum(out.astype(jnp.float32) * c["cv"])

    g = jax.grad(loss, argnums=(0, 1, 2))(c["proc"], jnp.asarray(c["v0"]), jnp.asarray(c["e0"]))
    return [np.asarray(x, np.float32) for x in (*jax.tree.leaves(g[0]), g[1], g[2])]


def _port_grads(c, dtype, proc=None, mps=MPS):
    tdt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    proc = c["port"] if proc is None else proc
    leaves = param_leaves(proc)
    for x in leaves:
        x.requires_grad_(True)
    v0, e0 = _t(c["v0"]).to(tdt), _t(c["e0"]).to(tdt)
    v0.requires_grad_(True)
    e0.requires_grad_(True)
    out = F.fused_process(proc, v0, e0, _t(c["s"]), _t(c["r"]), _t(c["row"]),
                          _t(c["ev"]).to(tdt), mps, sender_perm=_t(c["perm"]),
                          sender_offsets=_t(c["soff"]))
    got = torch.autograd.grad((out.double() * _t(c["cv"]).double()).sum(), [*leaves, v0, e0])
    return [g.double().numpy() for g in got]


def _witness(c):
    """The f64 witness: autograd of the plain three-part rounds in f64 from
    the same (f32) inputs and weights."""
    proc = {m: {k: ([t.double() for t in v] if isinstance(v, list) else v.double())
                for k, v in mlp.items()} for m, mlp in c["port"].items()}
    leaves = param_leaves(proc)
    for x in leaves:
        x.requires_grad_(True)
    v0 = _t(c["v0"]).double().requires_grad_(True)
    e0 = _t(c["e0"]).double().requires_grad_(True)
    out = F.process_rounds_plain(proc, v0, e0, _t(c["s"]).long(), _t(c["r"]).long(),
                                 _t(c["ev"]).double(), MPS, torch.float64, c["n"])
    got = torch.autograd.grad((out * _t(c["cv"]).double()).sum(), [*leaves, v0, e0])
    return [g.numpy() for g in got]


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# (latent, hidden layers, compute dtype): test_torch_preproject.py's cases
_JAX_CASES = [
    pytest.param(32, 2, "float32", id="L32-h2-f32"),
    pytest.param(128, 1, "float32", id="L128-h1-f32"),
    pytest.param(128, 3, "float32", id="L128-h3-f32"),
    pytest.param(32, 3, "bfloat16", id="L32-h3-bf16"),
    pytest.param(128, 2, "bfloat16", id="L128-h2-bf16"),
]
# bf16: each leaf's relative L2 distance from the JAX kernel's.  Both carry
# bf16 cotangents through 3 rounds, and each lies 0.06-0.19 from the f64
# witness at these shapes (the JAX forward adds f32 master biases, ROADMAP
# C2), so the two differ by up to 0.19 in either form.
BF16_REL = 0.25


@pytest.mark.parametrize("defer", [True, False], ids=["defer", "three-part"])
@pytest.mark.parametrize("latent,hidden,dtype", _JAX_CASES)
def test_fused_process_gradient_matches_jax_kernel_by_form(latent, hidden, dtype, defer):
    """Gradients of the port's fused_process on the CPU against jax.grad of
    the JAX package's fused kernel with its kernel backward (interpret
    mode), both packages' deferred first layer pinned the same way (and the
    JAX forward's preproject form with it, see _pinned): f32 at rtol/atol
    5e-4 (tests/test_fused.py's), bf16 at a relative L2 of BF16_REL per
    leaf."""
    c = _case(3, latent, hidden)
    ref = _pinned(defer, lambda: _jax_grads(c, dtype))
    got = _pinned(defer, lambda: _port_grads(c, dtype))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        if dtype == "float32":
            np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=str(i))
        else:
            assert np.isfinite(a).all() and _rel(a, b) <= BF16_REL, (i, _rel(a, b))


def test_backward_takes_the_defer_form_where_e_ge_n(monkeypatch):
    """The rule: defer where E >= N (the JAX backward's, without its VMEM
    gate), unless _FORCE_DEFER pins it; the backward then calls K4 without
    dvs/dvr, K1 on dh0 twice and K8 once a round."""
    assert F._FORCE_DEFER is None
    assert F._defer(512, 256) and F._defer(256, 256) and not F._defer(128, 256)
    monkeypatch.setattr(F, "_FORCE_DEFER", False)
    assert not F._defer(512, 256)
    monkeypatch.setattr(F, "_FORCE_DEFER", True)
    assert F._defer(128, 256)
    monkeypatch.setattr(F, "_FORCE_DEFER", None)
    calls = []
    for name in ("first_layer_adjoint", "edge_round_bwd"):
        fn = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _fn=fn, _name=name, **k: (
            calls.append((_name, k.get("defer"))), _fn(*a, **k))[1])
    c = _case(4, 32, 2)
    _port_grads(c, "float32")
    assert calls == [("edge_round_bwd", True), ("first_layer_adjoint", None)] * MPS
    calls.clear()
    _port_grads(_case(4, 32, 2, e=N // 2), "float32")
    assert calls == [("edge_round_bwd", None)] * MPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_defer_and_three_part_forms_agree_and_meet_the_f64_witness(dtype):
    """The port's two backward forms on the CPU differ only in summation
    order (and, in bf16, where dv's product is rounded): against each other
    and against the f64 witness, each leaf within relative L2 2e-6 (f32) or
    BF16_REL (bf16)."""
    c = _case(5, 32, 2)
    w = _witness(c)
    got = {d: _pinned(d, lambda: _port_grads(c, dtype)) for d in (True, False)}
    tol = 2e-6 if dtype == "float32" else BF16_REL
    for i, (a, b, x) in enumerate(zip(got[True], got[False], w)):
        assert _rel(a, b) <= tol and _rel(a, x) <= tol and _rel(b, x) <= tol, i
    if dtype == "float32":  # and the two forms really differ somewhere
        assert not all(np.array_equal(a, b) for a, b in zip(got[True], got[False]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [1, 2])
def test_edge_round_bwd_plain_defer_is_the_three_part_form_without_dvs_dvr(hidden, dtype):
    """K4's plain defer form returns the three-part form's de and MlpSaved
    bits and no dvs/dvr; the three-part form's dvs/dvr are dh0's products
    with W0's sender and receiver row blocks (rounded to the compute
    dtype), and summing dh0 by sender (receiver) before the product gives
    the same as summing dvs (dvr) after it, in f64."""
    c = _case(6, 32, hidden)
    em = F.round_params(F.cast_mlp(c["port"]["edge_mlp"], dtype), 0)
    rng = np.random.default_rng(7)
    v, e = _t(c["v0"]).to(dtype), _t(c["e0"]).to(dtype)
    s, r, ev = _t(c["s"]), _t(c["r"]), _t(c["ev"]).to(dtype)
    p, q = F.edge_project_plain(v, em)
    de = _t(rng.normal(size=(E, 32)).astype(np.float32)).to(dtype)
    dagg = _t(rng.normal(size=(N, 32)).astype(np.float32))
    de3, dvs, dvr, saved3 = F.edge_round_bwd_plain(de, dagg, e, p, q, s, r, ev, em)
    de1, saved1 = F.edge_round_bwd_plain(de, dagg, e, p, q, s, r, ev, em, defer=True)
    assert torch.equal(de1, de3)
    for a, b in zip([*saved1.dh, *saved1.post, saved1.ln], [*saved3.dh, *saved3.post, saved3.ln]):
        assert torch.equal(a, b)
    dh0, w0 = saved1.dh[0].double(), em["w"][0].double()
    assert dh0.dtype == torch.float64 and saved1.dh[0].dtype == dtype
    for got, rows, ids in ((dvs, w0[32:64], s), (dvr, w0[64:], r)):
        ref = dh0 @ rows.t()
        assert torch.allclose(got.double(), ref.to(dtype).double(), rtol=0, atol=0) or \
            (got.double() - ref).abs().max() <= 2.0 ** -7 * ref.abs().max()
        node = torch.zeros((N, 32), dtype=torch.float64).index_add_(0, ids.long(), dh0) @ rows.t()
        by_edge = torch.zeros((N, 32), dtype=torch.float64).index_add_(0, ids.long(), ref)
        assert torch.allclose(node, by_edge, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent", [32, 128])
def test_first_layer_adjoint_plain_is_the_direct_formula(latent, dtype):
    """K8's plain version: dv + rnd(G_s W_s^T + G_r W_r^T) with the f32
    node sums and the compute-dtype weights exact in f32: within one
    rounding of the compute dtype of dv + the f64 products (f32: within the
    f32 sums' error), the products never rounded to bf16 before their sum."""
    c = _case(8, latent, 2)
    em = F.round_params(F.cast_mlp(c["port"]["edge_mlp"], dtype), 2)
    rng = np.random.default_rng(9)
    g_s, g_r = (_t(rng.normal(size=(N, latent)).astype(np.float32)) for _ in range(2))
    dv = _t(rng.normal(size=(N, latent)).astype(np.float32)).to(dtype)
    got = F.first_layer_adjoint_plain(dv, g_s, g_r, em)
    assert got.dtype == dtype and got.shape == dv.shape
    w0 = em["w"][0].double()
    prod = g_s.double() @ w0[latent:2 * latent].t() + g_r.double() @ w0[2 * latent:].t()
    ref = dv.double() + prod
    if dtype == torch.float32:
        bound = (2 * latent * 2.0 ** -24) * (g_s.double().abs() @ w0[latent:2 * latent].abs().t()
                                              + g_r.double().abs() @ w0[2 * latent:].abs().t())
        assert ((got.double() - ref).abs() <= bound + 2.0 ** -24 * ref.abs() + 1e-30).all()
    else:
        # the f32 product rounded once to bf16, then the bf16 add rounded
        step = dv.double() + prod.float().to(dtype).double()
        assert ((got.double() - step).abs() <= 2.0 ** -8 * step.abs()).all()
        assert ((got.double() - ref).abs() <= 2.0 ** -7 * (dv.double().abs() + prod.abs())).all()
    # the kernel wrapper on the CPU runs the plain version in place
    out = dv.clone()
    F.first_layer_adjoint(out, g_s, g_r, em, None)
    assert torch.equal(out, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_wgrads_deferred_rows_are_the_node_space_products(dtype):
    """K6's defer_first group (plain path): dW0[0:L] from e against dh0
    with the bias, dW0[L:2L] = v^T G_s and dW0[2L:3L] = v^T G_r as N-row
    products (G f32, v in the compute dtype, exact in f32), in one call."""
    L = 32
    c = _case(10, L, 1)
    rng = np.random.default_rng(11)
    em = F.round_params(F.cast_mlp(c["port"]["edge_mlp"], dtype), 0)
    v, e = _t(c["v0"]).to(dtype), _t(c["e0"]).to(dtype)
    s, r, ev = _t(c["s"]), _t(c["r"]), _t(c["ev"]).to(dtype)
    p, q = F.edge_project_plain(v, em)
    de = _t(rng.normal(size=(E, L)).astype(np.float32)).to(dtype)
    _, saved = F.edge_round_bwd_plain(de, torch.zeros((N, L)), e, p, q, s, r, ev, em, defer=True)
    g_s = F.csr_segment_sum_plain(saved.dh[0], s, _t(c["soff"]), N, perm=_t(c["perm"]))
    g_r = F.csr_segment_sum_plain(saved.dh[0], r, _t(c["row"]), N)
    grads = F._unflatten_proc([torch.full_like(t, np.nan) for t in F._flatten_proc(c["port"])],
                              (2, 2))
    F.mlp_wgrads(saved, [(e, None)], grads["edge_mlp"], 0, deferred=[(v, g_s), (v, g_r)])
    gw = grads["edge_mlp"]["w"][0][0].double()
    dh0 = saved.dh[0].double()
    assert torch.allclose(gw[:L], e.double().t() @ dh0, rtol=1e-5, atol=1e-5)
    # the same as the three-part form's gathered products, in f64
    for k, (g, idx) in enumerate(((g_s, s), (g_r, r))):
        ref = v.double().t() @ g.double()
        assert torch.allclose(gw[(1 + k) * L:(2 + k) * L], ref, rtol=1e-5, atol=1e-5)
        gathered = v.double()[idx.long()].t() @ dh0  # G's f32 sums: within f32 rounding
        assert torch.allclose(ref, gathered, rtol=1e-5, atol=1e-5)
    assert torch.allclose(grads["edge_mlp"]["b"][0][0].double(), dh0.sum(0), rtol=1e-5,
                          atol=1e-5)
    assert not any(torch.isnan(t[0]).any() for t in  # round 0 of every stack written
                   [*grads["edge_mlp"]["w"], *grads["edge_mlp"]["b"],
                    grads["edge_mlp"]["ln_scale"], grads["edge_mlp"]["ln_bias"]])


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cloth_round_with_extra_gives_the_same_dxtr_in_both_forms(dtype):
    """A cloth training round (fused_process(mps=1) with a node_extra
    tensor): dxtr, K5's output before the edge stage, is the same bits in
    both forms; v0's gradient differs only in summation order."""
    c = _case(12, 32, 2)
    extra = _t(np.random.default_rng(13).normal(size=(N, 32)).astype(np.float32))

    def grads():
        proc = c["port"]
        leaves = param_leaves(proc)
        for x in leaves:
            x.requires_grad_(True)
        v0 = _t(c["v0"]).to(dtype).requires_grad_(True)
        x = extra.clone().requires_grad_(True)
        out = F.fused_process(proc, v0, _t(c["e0"]).to(dtype), _t(c["s"]), _t(c["r"]),
                              _t(c["row"]), _t(c["ev"]).to(dtype), 1,
                              sender_perm=_t(c["perm"]), sender_offsets=_t(c["soff"]),
                              node_extra=x)
        return torch.autograd.grad((out.float() * _t(c["cv"])).sum(), [x, v0, *leaves])

    got = {d: _pinned(d, grads) for d in (True, False)}
    assert torch.equal(got[True][0], got[False][0])
    assert got[True][0].abs().max() > 0
    tol = 2e-6 if dtype == torch.float32 else BF16_REL
    for a, b in zip(got[True][1:], got[False][1:]):
        assert _rel(a.double().numpy(), b.double().numpy()) <= tol
