"""Port: the processor rounds (ops/fused) against the JAX package's fused
Pallas kernel in interpret mode and its XLA reference, f32."""

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
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum
from tests.torch_support import local_graph

torch.set_num_threads(2)

N, E, LATENT, MPS = 256, 512, 32, 3


def _setup(seed, dead_edges=0):
    rng = np.random.default_rng(seed)
    s, r = local_graph(rng, N, E)
    if dead_edges:  # padded tail aimed at the trash node, as build_template does
        s[-dead_edges:] = N - 1
        r[-dead_edges:] = N - 1
    cfg = JaxMGNConfig(node_input_dim=8, edge_input_dim=3, output_dim=2,
                       latent_size=LATENT, hidden_layers=2, message_passing_steps=MPS)
    proc = jax_init_mgn(jax.random.PRNGKey(seed), cfg)["processor"]
    v0 = rng.normal(size=(N, LATENT)).astype(np.float32)
    e0 = rng.normal(size=(E, LATENT)).astype(np.float32)
    ev = np.ones((E, 1), np.float32)
    if dead_edges:
        ev[-dead_edges:] = 0.0
        e0[-dead_edges:] = 0.0
    row = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=N))]).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    port = dict(proc=params_from_jax(jax.tree.map(np.asarray, proc)), v0=t(v0), e0=t(e0),
                s=t(s), r=t(r), row=t(row), ev=t(ev))
    return proc, s, r, v0, e0, ev, port


def _plain(port):
    return F.process_rounds_plain(port["proc"], port["v0"], port["e0"], port["s"], port["r"],
                                  port["ev"], MPS, torch.float32, N)


def test_plain_matches_jax_fused_kernel():
    proc, s, r, v0, e0, ev, port = _setup(1)
    plan = build_fused_plan(s, r, N)
    assert plan is not None
    ref = jax_fused_process(proc, jnp.asarray(v0), jnp.asarray(e0), plan, jnp.asarray(s),
                            jnp.asarray(r), jnp.asarray(ev), MPS, interpret=True)
    np.testing.assert_allclose(_plain(port).numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dead_edges", [0, 40])
def test_plain_matches_process_rounds_xla(dead_edges):
    proc, s, r, v0, e0, ev, port = _setup(2, dead_edges)
    ref_v, ref_e = process_rounds_xla(proc, jnp.asarray(v0), jnp.asarray(e0), jnp.asarray(s),
                                      jnp.asarray(r), jnp.asarray(ev), MPS, jnp.float32, N,
                                      return_edges=True)
    v, e = F.process_rounds_plain(port["proc"], port["v0"], port["e0"], port["s"], port["r"],
                                  port["ev"], MPS, torch.float32, N, return_edges=True)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(ref_e), rtol=2e-5, atol=2e-5)
    if dead_edges:  # masked messages leave dead edges and the trash node's e alone
        assert not e.numpy()[-dead_edges:].any()


def test_wrappers_on_cpu_run_the_round_in_place():
    """fused_process's round loop, K2 -> K1 -> K3 through the wrappers (their
    plain versions on the CPU), equals the plain reference."""
    _, _, _, _, _, _, port = _setup(3, dead_edges=16)
    v, e = port["v0"].clone(), port["e0"].clone()
    for rnd in range(MPS):
        msg = F.edge_round(e, v, port["s"], port["r"], port["ev"],
                           F.round_params(port["proc"]["edge_mlp"], rnd))
        agg = csr_segment_sum(msg, port["r"], port["row"], N)
        F.node_round(v, agg, F.round_params(port["proc"]["node_mlp"], rnd))
    ref_v, ref_e = F.process_rounds_plain(port["proc"], port["v0"], port["e0"], port["s"],
                                          port["r"], port["ev"], MPS, torch.float32, N,
                                          return_edges=True)
    torch.testing.assert_close(v, ref_v, rtol=0, atol=0)
    torch.testing.assert_close(e, ref_e, rtol=0, atol=0)
    out = F.fused_process(port["proc"], port["v0"], port["e0"], port["s"], port["r"],
                          port["row"], port["ev"], MPS)
    torch.testing.assert_close(out, ref_v, rtol=0, atol=0)


def test_round_params_slices_one_round():
    _, _, _, _, _, _, port = _setup(4)
    rp = F.round_params(port["proc"]["edge_mlp"], 1)
    assert tuple(rp["w"][0].shape) == (3 * LATENT, LATENT)
    torch.testing.assert_close(rp["w"][2], port["proc"]["edge_mlp"]["w"][2][1])
    assert tuple(rp["ln_scale"].shape) == (LATENT,)
