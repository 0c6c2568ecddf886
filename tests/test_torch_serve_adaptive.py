"""Port: the adaptive Tsit5 with its controller on the device
(``mgn_tpu_torch.rollout.integrators.odeint_tsit5_loop``, a
``torch._higher_order_ops.while_loop``) and the serving artefact that traces
it (``export_simulator(solver="tsit5_adaptive")``), on the CPU: the loop
against the host controller (``odeint_tsit5_adaptive``) bit for bit with the
same tries per save interval, against the JAX function's tries, and the
artefact against the eager ``simulate`` (bits) and the JAX package's
adaptive artefact (rtol/atol 1e-4)."""

import io
import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import init_state
from mgn_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.data.synthetic import make_channel_mesh, make_trajectory, synthetic_meta
from mgn_tpu.serve import export_simulator as jax_export_simulator
from mgn_tpu.serve import load_simulator as jax_load_simulator
import mgn_tpu_torch
from mgn_tpu_torch.api import build_model_config
from mgn_tpu_torch.checkpoint.manager import load_model
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import save_checkpoint_from_jax
from mgn_tpu_torch.data.meta import load_meta
from mgn_tpu_torch.data.pipeline import Trajectory
from mgn_tpu_torch.data.prep import prepare_trajectory
from mgn_tpu_torch.rollout.evaluate import make_rollout_fn
from mgn_tpu_torch.rollout.integrators import odeint_tsit5_adaptive, odeint_tsit5_loop
from mgn_tpu_torch.serve import export_simulator, load_simulator

from tests.test_torch_integrators import _cos_jax, _jax_tries
from tests.test_torch_serve import OPS, PLAIN_ONLY, _online

torch.set_num_threads(2)

SMALL = dict(mps=3, layer_size=32, hidden_layers=2)
DT = 0.05  # save interval: wide enough for the controller to reject tries
SAVES = 5


def _cos_traced(y, t):
    """cos(t) in f64 rounded to f32, as ``_cos_jax`` (numpy) computes it,
    with no host read: a ``while_loop`` body traces it."""
    return torch.cos(t.double()).float() * torch.ones_like(y)


CASES = {  # tests/test_torch_integrators.py's problems
    "stiffish": (lambda y, t: -50.0 * y, lambda y, t: -50.0 * y, np.ones(2, np.float32),
                 np.linspace(0, 0.5, 6, dtype=np.float32), dict(rtol=1e-6, atol=1e-8, dt0=0.1)),
    "nonautonomous": (_cos_jax, _cos_traced, np.zeros(1, np.float32),
                      np.linspace(0, 3, 7, dtype=np.float32), dict(rtol=1e-7, atol=1e-9)),
    "nonuniform": (_cos_jax, _cos_traced, np.zeros(1, np.float32),
                   np.asarray([0.0, 0.01, 0.03, 0.5, 3.0, 5.5], np.float32),
                   dict(rtol=1e-7, atol=1e-9)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_device_controller_gives_the_host_controllers_bits_and_tries(name):
    """Both controllers run the same f32 arithmetic on the CPU: the same
    bits, and the loop's tries tensor is the host loop's ``stats``."""
    _, ft, y0, saveat, kw = CASES[name]
    stats = []
    ref = odeint_tsit5_adaptive(ft, torch.from_numpy(y0), torch.from_numpy(saveat),
                                stats=stats, **kw)
    ys, tries = odeint_tsit5_loop(ft, torch.from_numpy(y0), torch.from_numpy(saveat), **kw)
    assert tries.dtype == torch.int32 and tries.shape == (len(saveat) - 1, 2)
    assert [tuple(r) for r in tries.tolist()] == stats
    assert sum(r for _, r in stats) > 0  # the controller rejected tries
    assert torch.equal(ys, ref)


@pytest.mark.parametrize("name", list(CASES))
def test_device_controller_takes_the_jax_functions_tries(name):
    """Against the JAX function run op by op: the same tries per save
    interval and outputs within 1e-6 (the traced right-hand side gives
    ``_cos_jax``'s bits)."""
    fj, ft, y0, saveat, kw = CASES[name]
    ref, tries = _jax_tries(fj, y0, saveat, kw)
    ys, got = odeint_tsit5_loop(ft, torch.from_numpy(y0), torch.from_numpy(saveat), **kw)
    assert got.sum(1).tolist() == tries
    np.testing.assert_allclose(ys.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_device_controller_stops_after_max_steps():
    """At max_steps_per_interval tries an interval ends where it stands."""
    ys, tries = odeint_tsit5_loop(lambda y, t: -50.0 * y, torch.ones(2),
                                  torch.linspace(0, 0.5, 3), rtol=1e-6, atol=1e-8, dt0=0.1,
                                  max_steps_per_interval=3)
    assert tries.sum(1).tolist() == [3, 3] and torch.isfinite(ys).all()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A JAX checkpoint at width 32, 3 rounds, converted for the port; one
    initial frame of the 100-node channel mesh, 5 save intervals of 0.05."""
    root = tmp_path_factory.mktemp("adaptive")
    dt = 0.01
    meta = synthetic_meta(tl=10, n_train=1, n_valid=1, dt=dt)
    with open(root / "meta.json", "w") as f:
        json.dump(meta, f)
    pos, cells, node_type = make_channel_mesh(100, seed=0)
    vel = make_trajectory(pos, node_type, tl=10, dt=dt, seed=5)
    state, _, _ = init_state(meta, JaxArgs(seed=3, **SMALL), optax.sgd(1.0))
    t = jax_build_template(pos, node_type, cells=cells)
    mef = np.asarray(t.mesh_edge_features)[np.asarray(t.edge_mask)]
    norm = state.norm.replace(
        edge=_online(state.norm.edge, mef),
        node={**state.norm.node, "velocity": _online(state.norm.node["velocity"], vel)},
        output={"velocity": _online(state.norm.output["velocity"], np.diff(vel, axis=0) / dt)})
    state = state.replace(norm=jax.tree.map(lambda a: np.asarray(a), norm))
    jax_cp = str(root / "cp_jax")
    JaxCheckpointManager(jax_cp).save(state, loss=0.0)
    model = JaxCheckpointManager(jax_cp).restore_model(
        JaxCheckpointManager.model_subtree(state))
    torch_cp = str(root / "cp_torch")
    save_checkpoint_from_jax(jax.tree.map(np.asarray, model), torch_cp)
    times = (np.arange(SAVES + 1) * DT).astype(np.float32)
    mesh = dict(mesh_pos=pos, node_type=node_type, cells=cells)
    blob = export_simulator(str(root), torch_cp, num_steps=len(times), solver="tsit5_adaptive",
                            device="cpu", **mesh, **SMALL)
    return dict(root=str(root), jax_cp=jax_cp, torch_cp=torch_cp, mesh=mesh, v0=vel[0],
                times=times, blob=blob)


def _host_tries(c):
    """The host controller's tries per save interval on the case."""
    args = Args(**SMALL).resolve_auto()
    meta = load_meta(c["root"])
    cfg, spec = build_model_config(meta, args)
    params, norm = load_model(c["torch_cp"], False, torch.device("cpu"))
    traj = Trajectory(mesh_pos=c["mesh"]["mesh_pos"], node_type=c["mesh"]["node_type"],
                      times=c["times"][:1], fields={"velocity": c["v0"][None]},
                      cells=c["mesh"]["cells"], edges=None)
    prep = prepare_trajectory(traj, meta, spec)
    stats = []
    rollout = make_rollout_fn(cfg, spec, solver="tsit5_adaptive", forced=False, stats=stats)
    with torch.no_grad():
        rollout(params, norm, prep.template, prep.fields, torch.from_numpy(c["times"]),
                prep.times)
    return stats


def test_adaptive_artefact_gives_simulate_bits_and_tries(case):
    c = case
    sim = load_simulator(c["blob"], device="cpu")
    out = sim(c["times"], c["v0"])
    ref = mgn_tpu_torch.simulate(c["root"], c["torch_cp"], initial_fields={"velocity": c["v0"]},
                                 times=c["times"], solver="tsit5_adaptive", device="cpu",
                                 **c["mesh"], **SMALL)
    assert out.shape == ref.shape == (SAVES + 1, 100, 2)
    assert np.abs(out[-1] - out[0]).max() > 1e-3
    assert np.array_equal(out, ref)
    assert sim.stats == _host_tries(c) and sum(r for _, r in sim.stats) > 0


def test_adaptive_artefact_matches_jax_artefact(case):
    c = case
    jblob = jax_export_simulator(c["root"], c["jax_cp"], num_steps=len(c["times"]),
                                 solver="tsit5_adaptive", **c["mesh"], **SMALL)
    ref = np.asarray(jax_load_simulator(jblob)(jnp.asarray(c["times"]), jnp.asarray(c["v0"])))
    out = load_simulator(c["blob"], device="cpu")(c["times"], c["v0"])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_adaptive_graph_holds_one_try_in_a_while_loop(case):
    """The program holds two while_loops (the save intervals and one
    interval's tries), the seven forwards of one try once, no host read and
    no op of a plain version."""
    program = torch.export.load(io.BytesIO(case["blob"]))
    calls = Counter(str(n.target) for m in program.graph_module.modules()
                    for n in m.graph.nodes if n.op == "call_function")
    assert calls["while_loop"] == 2
    rounds = 7 * SMALL["mps"]
    assert {op: calls[f"mgn_tpu_torch.{op}.default"] for op in OPS} == dict(
        weight_streams=7, edge_project=rounds, edge_round=rounds, csr_segment_sum=rounds,
        node_round=rounds)
    assert not [k for k in calls if any(p in k for p in PLAIN_ONLY)], sorted(calls)
    assert not [k for k in calls if "aten.item" in k or "_local_scalar_dense" in k]
