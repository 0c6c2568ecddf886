"""Port: data/prep.prepare_trajectory and rollout/evaluate.make_rollout_fn
(forced and unforced dynamics) against the JAX package, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import build_model_config as jax_build_model_config
from mgn_tpu.api import init_state
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.data.pipeline import Trajectory as JaxTrajectory
from mgn_tpu.data.prep import prepare_trajectory as jax_prepare_trajectory
from mgn_tpu.data.synthetic import make_channel_mesh, make_trajectory, synthetic_meta
from mgn_tpu.rollout.evaluate import make_rollout_fn as jax_make_rollout_fn
from mgn_tpu.train.common import FieldSpec as JaxFieldSpec
from mgn_tpu_torch.api import build_model_config
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax
from mgn_tpu_torch.data.pipeline import Trajectory
from mgn_tpu_torch.data.prep import prepare_trajectory
from mgn_tpu_torch.rollout.evaluate import make_rollout_fn
from mgn_tpu_torch.train.common import FieldSpec

torch.set_num_threads(2)

SMALL = dict(mps=2, layer_size=32, hidden_layers=2)
DT = 0.01


def _online_from(norm, x):
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    return norm.replace(acc_count=np.float32(1.0), num_accumulations=np.float32(len(x)),
                        acc_sum=x.sum(0).astype(np.float32),
                        acc_sum_sq=(x * x).sum(0).astype(np.float32))


@pytest.fixture(scope="module")
def case():
    meta = synthetic_meta(tl=5, n_train=1, n_valid=1, dt=DT)
    pos, cells, nt = make_channel_mesh(80, seed=2)
    vel = make_trajectory(pos, nt, tl=5, dt=DT, seed=4)
    times = (np.arange(5) * DT).astype(np.float32)
    jtraj = JaxTrajectory(mesh_pos=pos, node_type=nt, times=times,
                          fields={"velocity": vel}, cells=cells)
    ttraj = Trajectory(mesh_pos=pos, node_type=nt, times=times,
                       fields={"velocity": vel}, cells=cells)
    state, _, _ = init_state(meta, JaxArgs(seed=5, **SMALL), optax.sgd(1.0))
    norm = state.norm.replace(
        edge=_online_from(state.norm.edge, np.random.default_rng(6).normal(0.1, 0.05, (50, 3))),
        node={**state.norm.node, "velocity": _online_from(state.norm.node["velocity"], vel)},
        output={"velocity": _online_from(state.norm.output["velocity"],
                                         np.diff(vel, axis=0) / DT)})
    return dict(meta=meta, jtraj=jtraj, ttraj=ttraj, times=times, params=state.params,
                norm=jax.tree.map(np.asarray, norm))


def test_prepare_trajectory_matches_jax(case):
    jp = jax_prepare_trajectory(case["jtraj"], case["meta"], JaxFieldSpec.from_meta(case["meta"]))
    tp = prepare_trajectory(case["ttraj"], case["meta"], FieldSpec.from_meta(case["meta"]))
    assert tp.template.num_nodes == jp.template.num_nodes
    np.testing.assert_array_equal(tp.fields["velocity"].numpy(),
                                  np.asarray(jp.fields["velocity"]))
    np.testing.assert_array_equal(tp.times.numpy(), np.asarray(jp.times))
    per_node = np.random.default_rng(0).normal(size=(3, tp.template.num_nodes, 2))
    np.testing.assert_array_equal(tp.unpermute(per_node), jp.unpermute(per_node))


def _port_rollout(case, solver, forced):
    tcfg, tspec = build_model_config(case["meta"], Args(**SMALL))
    tp = prepare_trajectory(case["ttraj"], case["meta"], tspec)
    return make_rollout_fn(tcfg, tspec, solver=solver, forced=forced)(
        params_from_jax(jax.tree.map(np.asarray, case["params"])), norm_from_jax(case["norm"]),
        tp.template, tp.fields, torch.from_numpy(case["times"]))


@pytest.mark.parametrize("solver,forced", [("euler", True), ("euler", False),
                                           ("heun", False)])
def test_rollout_matches_jax(case, solver, forced):
    meta = case["meta"]
    jcfg, jspec = jax_build_model_config(meta, JaxArgs(**SMALL))
    jp = jax_prepare_trajectory(case["jtraj"], meta, jspec)
    ref = jax_make_rollout_fn(jcfg, jspec, solver=solver, forced=forced)(
        case["params"], case["norm"], jp.template, jp.fields, jnp.asarray(case["times"]))
    out = _port_rollout(case, solver, forced)
    assert tuple(out.shape) == ref.shape
    n = case["ttraj"].num_nodes
    np.testing.assert_allclose(out.numpy()[:, :n], np.asarray(ref)[:, :n], rtol=1e-4,
                               atol=1e-4)
    if forced:  # the inflow ground truth reaches the updated nodes
        free = _port_rollout(case, solver, False)
        assert np.abs(out.numpy()[-1, :n] - free.numpy()[-1, :n]).max() > 1e-6
