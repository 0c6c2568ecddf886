"""Port: the processor's pre-projected first layer (the TPU kernel's
``preproject`` form) — K7's plain version ``edge_project_plain``, the edge
stage on the gathered f32 projections, the projection weight stream, and
the port's ``fused_process`` against the JAX package's fused kernel in
interpret mode with its ``preproject`` form forced on and off.

The kernels themselves (K7, K2 and K4 in this form) are held against these
plain versions on the card in ``tests/test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgn_tpu.ops.fused as JF
from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.ops.fused import build_fused_plan, process_rounds_xla
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.models.mlp import apply_mlp_parts
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.train.common import param_leaves
from tests.torch_support import local_graph

torch.set_num_threads(2)

N, E, MPS = 256, 512, 3
F32_TOL = dict(rtol=2e-5, atol=2e-5)
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
    return dict(proc=proc, s=s, r=r, v0=v0, e0=e0, ev=ev, row=row, n=n,
                port=params_from_jax(jax.tree.map(np.asarray, proc)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_forward(c, dtype):
    tdt = getattr(torch, dtype)
    return F.fused_process(c["port"], _t(c["v0"]).to(tdt), _t(c["e0"]).to(tdt), _t(c["s"]),
                           _t(c["r"]), _t(c["row"]), _t(c["ev"]).to(tdt), MPS)


def _jax_kernel(c, dtype, preproject, **kw):
    """The JAX package's fused kernel (interpret mode) with its preproject
    form pinned (None: its own rule), the kernel cache cleared around the
    call and the hook restored, as tests/test_fused.py pins it."""
    jdt = getattr(jnp, dtype)
    plan = build_fused_plan(c["s"], c["r"], c["n"])
    assert plan is not None
    JF._FORCE_PREPROJECT = preproject
    JF._make_fused.cache_clear()
    try:
        return JF.fused_process(c["proc"], jnp.asarray(c["v0"]).astype(jdt),
                                jnp.asarray(c["e0"]).astype(jdt), plan, jnp.asarray(c["s"]),
                                jnp.asarray(c["r"]), jnp.asarray(c["ev"]).astype(jdt), MPS,
                                interpret=True, **kw)
    finally:
        JF._FORCE_PREPROJECT = None
        JF._make_fused.cache_clear()


def _assert_forward_close(got, ref, dtype):
    """f32: rtol/atol 2e-5.  bf16, with bf16 inputs on both sides: the
    tolerances of test_torch_fused.py's test_plain_matches_process_rounds_xla
    (relative L2 <= 2e-2, every entry within 2^-5 x max |ref|): both round
    to bf16 at the same points, but sums in other orders flip a bf16
    rounding now and then and 3 rounds carry the flips on."""
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **F32_TOL)
    else:
        assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
        assert np.abs(got - ref).max() <= 2.0 ** -5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent", [32, 128])
def test_edge_project_plain_is_the_f64_product(latent, dtype):
    """K7's plain version: P = v W0[L:2L], Q = v W0[2L:3L] as f32 sums of
    the compute-dtype operands' products (no bias, no rounding to the
    compute dtype), against an f64 numpy product of the same operands."""
    c = _case(1, latent, 2)
    em = F.round_params(F.cast_mlp(c["port"]["edge_mlp"], dtype), 1)
    v = _t(c["v0"]).to(dtype)
    p, q = F.edge_project_plain(v, em)
    assert p.dtype == q.dtype == torch.float32 and p.shape == q.shape == (N, latent)
    w0 = em["w"][0].double().numpy()
    vd = v.double().numpy()
    for got, rows in ((p, w0[latent:2 * latent]), (q, w0[2 * latent:])):
        ref = vd @ rows
        # an f32 sum of `latent` terms: within latent * 2^-24 * sum |v w|
        bound = latent * 2.0 ** -24 * (np.abs(vd) @ np.abs(rows))
        assert (np.abs(got.double().numpy() - ref) <= bound + 1e-30).all()
    if dtype == torch.bfloat16:  # the raw f32 products, not rounded to bf16
        assert not torch.equal(p, p.to(dtype).float())


# (latent, hidden layers, compute dtype)
_JAX_CASES = [
    pytest.param(32, 2, "float32", id="L32-h2-f32"),
    pytest.param(128, 1, "float32", id="L128-h1-f32"),
    pytest.param(128, 3, "float32", id="L128-h3-f32"),
    pytest.param(32, 3, "bfloat16", id="L32-h3-bf16"),
    pytest.param(128, 2, "bfloat16", id="L128-h2-bf16"),
]


@pytest.mark.parametrize("preproject", [True, False])
@pytest.mark.parametrize("latent,hidden,dtype", _JAX_CASES)
def test_fused_process_matches_jax_kernel(latent, hidden, dtype, preproject):
    """The port's fused_process on the CPU (the pre-projected form at every
    shape) against the JAX package's fused kernel in interpret mode, its
    preproject form forced on (the form the JAX forward takes at every real
    mesh) and off (the three-part first layer): the two forms differ only in
    summation order."""
    c = _case(2, latent, hidden)
    ref = _jax_kernel(c, dtype, preproject)
    _assert_forward_close(_port_forward(c, dtype), ref, dtype)


@pytest.mark.parametrize("latent,hidden", [(32, 2), (128, 1)])
def test_fused_process_gradient_matches_jax_kernel(latent, hidden):
    """Gradients of the port's fused_process on the CPU (its backward
    recomputes P and Q from the saved v, as the TPU backward does) against
    jax.grad of the JAX package's fused kernel with its kernel backward,
    interpret mode, preproject forced on and the deferred first-layer
    scatter left to its own rule: rtol/atol 5e-4 (tests/test_fused.py's)."""
    c = _case(3, latent, hidden)
    cv = np.random.default_rng(4).normal(size=(N, latent)).astype(np.float32)

    def loss(p, v, e_):
        plan = build_fused_plan(c["s"], c["r"], N)
        out = JF.fused_process(p, v, e_, plan, jnp.asarray(c["s"]), jnp.asarray(c["r"]),
                               jnp.asarray(c["ev"]), MPS, interpret=True, kernel_bwd=True)
        return jnp.sum(out * cv)

    JF._FORCE_PREPROJECT = True
    JF._make_fused.cache_clear()
    try:
        jg = jax.grad(loss, argnums=(0, 1, 2))(c["proc"], jnp.asarray(c["v0"]),
                                               jnp.asarray(c["e0"]))
    finally:
        JF._FORCE_PREPROJECT = None
        JF._make_fused.cache_clear()
    proc = c["port"]
    leaves = param_leaves(proc)
    v0, e0 = _t(c["v0"]).requires_grad_(True), _t(c["e0"]).requires_grad_(True)
    for x in leaves:
        x.requires_grad_(True)
    sender_perm = np.argsort(c["s"], kind="stable").astype(np.int32)
    sender_offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(c["s"], minlength=N))]).astype(np.int32)
    out = F.fused_process(proc, v0, e0, _t(c["s"]), _t(c["r"]), _t(c["row"]), _t(c["ev"]), MPS,
                          sender_perm=_t(sender_perm), sender_offsets=_t(sender_offsets))
    got = torch.autograd.grad((out * _t(cv)).sum(), [*leaves, v0, e0])
    ref = [*jax.tree.leaves(jg[0]), jg[1], jg[2]]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL, err_msg=str(i))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_process_below_e_ge_n_matches_the_jax_three_part_form(dtype):
    """Fewer edges than nodes, where the JAX forward keeps the three-part
    first layer (its E >= N rule): the port still projects, and matches
    the JAX kernel and process_rounds_xla at the same tolerances."""
    c = _case(5, 32, 2, n=N, e=N // 2)
    got = _port_forward(c, dtype)
    _assert_forward_close(got, _jax_kernel(c, dtype, None), dtype)
    jdt = getattr(jnp, dtype)
    xla = process_rounds_xla(c["proc"], jnp.asarray(c["v0"]).astype(jdt),
                             jnp.asarray(c["e0"]).astype(jdt), jnp.asarray(c["s"]),
                             jnp.asarray(c["r"]), jnp.asarray(c["ev"]).astype(jdt), MPS, jdt, N)
    _assert_forward_close(got, xla, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [1, 2, 3])
def test_edge_round_bwd_plain_recomputes_the_forward_relu_outputs(hidden, dtype):
    """The plain K4's recompute, from the same projections, gives the plain
    forward's ReLU outputs bit for bit: each hidden layer's input equals
    ReLU of the forward cut after that layer (apply_mlp_parts with the
    first layer's extra, no LayerNorm)."""
    c = _case(6, 32, hidden)
    em = F.round_params(F.cast_mlp(c["port"]["edge_mlp"], dtype), 0)
    v, e = _t(c["v0"]).to(dtype), _t(c["e0"]).to(dtype)
    s, r, ev = _t(c["s"]), _t(c["r"]), _t(c["ev"]).to(dtype)
    p, q = F.edge_project_plain(v, em)
    de, dagg = torch.ones_like(e), torch.zeros((N, 32))
    saved = F.edge_round_bwd_plain(de, dagg, e, p, q, s, r, ev, em)[3]
    assert len(saved.post) == hidden
    extra = p[s.long()] + q[r.long()]
    w0e = em["w"][0][:32]
    for i, post in enumerate(saved.post):
        cut = {"w": [w0e, *em["w"][1:i + 1]], "b": em["b"][:i + 1]}
        assert torch.equal(post, torch.relu(apply_mlp_parts(cut, (e,), dtype, extra=extra)))
    # and the forward itself: the plain edge stage's messages from the same inputs
    msg = F.edge_round_plain(e, p, q, s, r, ev, em)[1]
    first = dict(em, w=[w0e, *em["w"][1:]])
    assert torch.equal(msg, apply_mlp_parts(first, (e,), dtype, extra=extra) * ev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (128, 2), (256, 3)])
def test_projection_stream_plain_layout(dtype, latent, hidden):
    """K7's weight stream, per round: the edge MLP's first-layer sender rows
    W0[L:2L], then its receiver rows W0[2L:3L], exactly, each padded with 8
    zeros (the node stream's row layout); made with adjoint, the same
    leading part followed by K8's rows, B = W^T of the two row blocks; none
    without an edge MLP."""
    c = _case(7, latent, hidden)
    em = F.cast_mlp(c["port"]["edge_mlp"], dtype)
    nm = F.cast_mlp(c["port"]["node_mlp"], dtype)
    proj = F.weight_streams_plain(em, nm)[2]
    assert proj.dtype == dtype
    assert tuple(proj.shape) == (MPS, F._stream_sizes(latent, dtype, len(em["w"]), 0)[2])
    rows = proj.view(MPS, 2 * latent, latent + 8)
    assert torch.equal(rows[:, :, :latent], em["w"][0][:, latent:])
    assert not rows[:, :, latent:].any()
    adj = F.weight_streams_plain(em, nm, adjoint=True)[2]
    assert tuple(adj.shape) == (MPS, F._stream_sizes(latent, dtype, 0, 0, adjoint=True)[2])
    assert torch.equal(adj[:, :proj.shape[1]], proj)
    k8 = adj[:, proj.shape[1]:].view(MPS, 2, latent, latent + 8)
    for part in range(2):
        block = em["w"][0][:, (1 + part) * latent:(2 + part) * latent]
        assert torch.equal(k8[:, part, :, :latent], block.transpose(-1, -2))
    assert not k8[..., latent:].any()
    assert F.weight_streams_plain(nm=nm)[2] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_process_is_the_pre_projected_plain_rounds(dtype):
    """On the CPU fused_process equals process_rounds_plain(preproject=True)
    bit for bit, with and without a node_extra hook (the cloth family's
    serving form), and differs from the three-part form only in summation
    order."""
    c = _case(8, 32, 2)
    args = (_t(c["v0"]).to(dtype), _t(c["e0"]).to(dtype), _t(c["s"]), _t(c["r"]))
    ev = _t(c["ev"]).to(dtype)
    w = torch.from_numpy(np.random.default_rng(9).normal(size=(MPS, 32, 32)).astype(np.float32))
    for hook in (None, lambda r, v: torch.tanh(v.float()) @ w[r]):
        out = F.fused_process(c["port"], *args, _t(c["row"]), ev, MPS, node_extra=hook)
        ref = F.process_rounds_plain(c["port"], *args, ev, MPS, dtype, N, node_extra=hook,
                                     preproject=True)
        assert torch.equal(out, ref)
        three = F.process_rounds_plain(c["port"], *args, ev, MPS, dtype, N, node_extra=hook)
        if dtype == torch.float32:
            torch.testing.assert_close(out, three, **F32_TOL)
