"""Port: the processor's backward (ops/fused: the autograd Function with the
plain versions of K4/K5/K6/K1-perm on the CPU) against ``jax.grad`` of
``process_rounds_xla`` and the JAX package's P5 backward kernel in
interpret mode, f32; each plain kernel against ``torch.autograd`` of the
forward it reverses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.ops.fused import build_fused_plan, fused_process as jax_fused_process
from mgn_tpu.ops.fused import process_rounds_xla
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.core.graph import build_template, sender_csr
from mgn_tpu_torch.data.synthetic import make_channel_mesh
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum_plain
from mgn_tpu_torch.train.common import param_leaves
from tests.torch_support import local_graph

torch.set_num_threads(2)

N, E, LATENT, MPS = 256, 512, 32, 3  # the shapes of tests/test_fused.py's backward test
TOL = dict(rtol=5e-4, atol=5e-4)


def _setup(seed, dead_edges=0):
    rng = np.random.default_rng(seed)
    s, r = local_graph(rng, N, E)
    if dead_edges:  # padded tail aimed at the trash node, as build_template does
        s[-dead_edges:] = N - 1
        r[-dead_edges:] = N - 1
    cfg = JaxMGNConfig(node_input_dim=8, edge_input_dim=3, output_dim=2,
                       latent_size=LATENT, hidden_layers=2, message_passing_steps=MPS)
    proc = jax_init_mgn(jax.random.PRNGKey(seed), cfg)["processor"]
    # non-trivial biases and LayerNorm parameters, so their gradients are exercised
    proc = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype), proc)
    v0 = rng.normal(size=(N, LATENT)).astype(np.float32)
    e0 = rng.normal(size=(E, LATENT)).astype(np.float32)
    ev = np.ones((E, 1), np.float32)
    if dead_edges:
        ev[-dead_edges:] = 0.0
        e0[-dead_edges:] = 0.0
    return proc, s, r, v0, e0, ev


def _loss_jax(out):
    return jnp.sum(out ** 2) + jnp.sum(out[:, 0])


def _port_grads(proc, s, r, v0, e0, ev):
    """Gradients of the port's fused_process (CPU: the Function over the
    plain kernels), in jax.tree.leaves order: (processor leaves, v0, e0)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    p = params_from_jax(jax.tree.map(np.asarray, proc))
    leaves = param_leaves(p)
    v, e = t(v0).requires_grad_(True), t(e0).requires_grad_(True)
    for x in leaves:
        x.requires_grad_(True)
    row = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=N))]).astype(np.int32)
    perm, offsets = sender_csr(s, N)
    out = F.fused_process(p, v, e, t(s), t(r), t(row), t(ev), MPS,
                          sender_perm=t(perm), sender_offsets=t(offsets))
    assert out.grad_fn is not None  # the autograd Function, not plain autograd
    grads = torch.autograd.grad((out ** 2).sum() + out[:, 0].sum(), [*leaves, v, e])
    return [g.numpy() for g in grads]


def test_backward_matches_jax_grad_and_the_p5_interpret_kernel():
    proc, s, r, v0, e0, ev = _setup(3)
    sj, rj, evj = jnp.asarray(s), jnp.asarray(r), jnp.asarray(ev)
    plan = build_fused_plan(s, r, N)
    assert plan is not None

    def loss_xla(p, v, e_):
        return _loss_jax(process_rounds_xla(p, v, e_, sj, rj, evj, MPS, jnp.float32, N))

    def loss_p5(p, v, e_):
        return _loss_jax(jax_fused_process(p, v, e_, plan, sj, rj, evj, MPS,
                                           interpret=True, kernel_bwd=True))

    got = _port_grads(proc, s, r, v0, e0, ev)
    for loss in (loss_xla, loss_p5):
        gp, gv, ge = jax.grad(loss, argnums=(0, 1, 2))(proc, jnp.asarray(v0), jnp.asarray(e0))
        ref = [np.asarray(x) for x in jax.tree.leaves(gp)] + [np.asarray(gv), np.asarray(ge)]
        assert len(ref) == len(got)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **TOL)


def test_dead_edges_get_no_gradient():
    """Masked messages: a dead edge's latent gets exactly zero gradient, and
    the rest still matches jax.grad of process_rounds_xla."""
    dead = 40
    proc, s, r, v0, e0, ev = _setup(4, dead_edges=dead)
    sj, rj, evj = jnp.asarray(s), jnp.asarray(r), jnp.asarray(ev)
    gp, gv, ge = jax.grad(
        lambda p, v, e_: _loss_jax(process_rounds_xla(p, v, e_, sj, rj, evj, MPS,
                                                      jnp.float32, N)),
        argnums=(0, 1, 2))(proc, jnp.asarray(v0), jnp.asarray(e0))
    got = _port_grads(proc, s, r, v0, e0, ev)
    assert not got[-1][-dead:].any()
    ref = [np.asarray(x) for x in jax.tree.leaves(gp)] + [np.asarray(gv), np.asarray(ge)]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL)


def test_sender_perm_segment_sum_matches_jax_segment_sum():
    pos, cells, nt = make_channel_mesh(150, seed=1)
    t = build_template(pos, nt, cells=cells)
    s = t.senders.numpy()
    assert (np.diff(s[t.sender_perm.numpy()]) >= 0).all()
    data = np.random.default_rng(5).normal(size=(t.num_edges, 12)).astype(np.float32)
    out = csr_segment_sum_plain(torch.from_numpy(data), t.senders, t.sender_offsets,
                                t.num_nodes, perm=t.sender_perm)
    ref = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(s), t.num_nodes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _round_case(seed, latent=16, hidden=2, n=60, e=300):
    rng = np.random.default_rng(seed)
    s, r = local_graph(rng, n, e, spread=10)
    s[-20:], r[-20:] = n - 1, n - 1
    ev = torch.ones((e, 1))
    ev[-20:] = 0
    g = torch.Generator().manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g)
    mlp = lambda parts: {"w": [mk(parts * latent, latent) / latent ** 0.5]
                         + [mk(latent, latent) / latent ** 0.5 for _ in range(hidden)],
                         "b": [0.1 * mk(latent) for _ in range(hidden + 1)],
                         "ln_scale": 1 + 0.1 * mk(latent), "ln_bias": 0.1 * mk(latent)}
    return (torch.from_numpy(s), torch.from_numpy(r), ev, mk, mlp)


def _check_wgrads(saved, inputs, mlp, auto_grads):
    """K6's plain version over ``saved`` against autograd's weight, bias and
    LayerNorm gradients."""
    L, n = saved.dh[0].shape[1], len(mlp["w"])
    gw, gb = auto_grads[:n], auto_grads[n: 2 * n]
    dw0 = torch.cat([F.wgrad_plain(saved.dh[0], x, idx)[0] for x, idx in inputs])
    torch.testing.assert_close(dw0, gw[0], **TOL)
    torch.testing.assert_close(F.wgrad_plain(saved.dh[0])[1], gb[0], **TOL)
    for i in range(1, n):
        dw, db = F.wgrad_plain(saved.dh[i], saved.post[i - 1])
        torch.testing.assert_close(dw, gw[i], **TOL)
        torch.testing.assert_close(db, gb[i], **TOL)
    ln = F.wgrad_plain(saved.ln)[1]
    torch.testing.assert_close(ln[:L], auto_grads[-2], **TOL)
    torch.testing.assert_close(ln[L:], auto_grads[-1], **TOL)


@pytest.mark.parametrize("hidden", [1, 2])
def test_edge_round_bwd_plain_is_the_autograd_of_edge_round(hidden):
    s, r, ev, mk, make_mlp = _round_case(6, hidden=hidden)
    n, e_rows, L = 60, 300, 16
    mlp = make_mlp(3)
    e, v = mk(e_rows, L) * ev, mk(n, L)
    de, dagg = mk(e_rows, L), mk(n, L)
    leaves = [*mlp["w"], *mlp["b"], mlp["ln_scale"], mlp["ln_bias"]]
    for x in (e, v, *leaves):
        x.requires_grad_(True)
    p, q = F.edge_project_plain(v, mlp)
    new_e, msg = F.edge_round_plain(e, p, q, s, r, ev, mlp)
    agg = csr_segment_sum_plain(msg, r, None, n)
    auto = torch.autograd.grad((new_e * de).sum() + (agg * dagg).sum(), [e, v, *leaves])
    with torch.no_grad():
        new_de, dvs, dvr, saved = F.edge_round_bwd_plain(de, dagg, e, p, q, s, r, ev, mlp)
    torch.testing.assert_close(new_de, auto[0], **TOL)
    perm, offsets = sender_csr(s.numpy(), n)
    dv = (csr_segment_sum_plain(dvr, r, None, n)
          + csr_segment_sum_plain(dvs, s, torch.from_numpy(offsets), n,
                                  perm=torch.from_numpy(perm)))
    torch.testing.assert_close(dv, auto[1], **TOL)
    assert not dvs[-20:].any() and not dvr[-20:].any()
    _check_wgrads(saved, [(e.detach(), None), (v.detach(), s), (v.detach(), r)], mlp,
                  auto[2:])


@pytest.mark.parametrize("hidden", [1, 2])
def test_node_round_bwd_plain_is_the_autograd_of_node_round(hidden):
    _, _, _, mk, make_mlp = _round_case(7, hidden=hidden)
    n, L = 60, 16
    mlp = make_mlp(2)
    v, agg, dv = mk(n, L), mk(n, L), mk(n, L)
    leaves = [*mlp["w"], *mlp["b"], mlp["ln_scale"], mlp["ln_bias"]]
    for x in (v, agg, *leaves):
        x.requires_grad_(True)
    auto = torch.autograd.grad((F.node_round_plain(v, agg, mlp) * dv).sum(), [v, agg, *leaves])
    with torch.no_grad():
        new_dv, dagg, saved = F.node_round_bwd_plain(dv, v, agg, mlp)
    torch.testing.assert_close(new_dv, auto[0], **TOL)
    torch.testing.assert_close(dagg, auto[1], **TOL)
    _check_wgrads(saved, [(v.detach(), None), (agg.detach(), None)], mlp, auto[2:])


def test_return_edges_backward_takes_both_cotangents():
    """With return_edges the Function's backward seeds the edge carry with the
    incoming edge cotangent: its gradients equal autograd of the plain rounds."""
    proc, s, r, v0, e0, ev = _setup(9, dead_edges=16)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    p = params_from_jax(jax.tree.map(np.asarray, proc))
    leaves = param_leaves(p)
    v, e = t(v0).requires_grad_(True), t(e0).requires_grad_(True)
    for x in leaves:
        x.requires_grad_(True)
    row = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=N))]).astype(np.int32)
    perm, offsets = sender_csr(s, N)
    loss = lambda out: (out[0] ** 2).sum() + (out[1] * out[1][:, :1]).sum()
    got = torch.autograd.grad(loss(F.fused_process(p, v, e, t(s), t(r), t(row), t(ev), MPS,
                                                   return_edges=True, sender_perm=t(perm),
                                                   sender_offsets=t(offsets))),
                              [*leaves, v, e])
    with pytest.raises(ValueError, match="sender"):
        F.fused_process(p, v, e, t(s), t(r), t(row), t(ev), MPS)
    ref = torch.autograd.grad(loss(F.process_rounds_plain(p, v, e, t(s), t(r), t(ev), MPS,
                                                          torch.float32, N,
                                                          return_edges=True)),
                              [*leaves, v, e])
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **TOL)
