"""Port: solver training (``train/solver.py``: SolverTraining and
MultipleShooting through the fixed-step solvers and the bounded adaptive
Tsit5) against ``mgn_tpu.train.solver.make_solver_trainer`` on the CPU, at
tests/test_solver_train.py's size (40 nodes, 10 frames, width 8, one hidden
layer), from the JAX package's initial parameters carried across by
``params_from_jax``.  Solver strategies are noise-free, so losses, whole-model
gradients and parameters compare directly: the loss within rtol 1e-4, the
gradient within PERF.md §2's training tolerance, the parameters after three
Adam steps within rtol 1e-3.  The JAX side records each step's gradient
through an optax transformation that keeps it as its state."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import init_state as jax_init_state
from mgn_tpu.api import train_network as jax_train_network
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.prep import common_buckets as jax_common_buckets
from mgn_tpu.data.prep import prepare_trajectory as jax_prepare_trajectory
from mgn_tpu.data.union import union_prepared as jax_union_prepared
from mgn_tpu.train import strategies as JS
from mgn_tpu.train.solver import SolverTrainerConfig as JaxSolverConfig
from mgn_tpu.train.solver import make_solver_trainer as jax_make_solver_trainer
from mgn_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
import mgn_tpu_torch
from mgn_tpu_torch.api import build_model_config
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax, save_train_state_from_jax
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.prep import prepare_trajectory
from mgn_tpu_torch.data.synthetic import write_synthetic_tfrecord_dataset
from mgn_tpu_torch.data.union import union_prepared
from mgn_tpu_torch.train import strategies as TS
from mgn_tpu_torch.train.common import TrainState, param_leaves
from mgn_tpu_torch.train.solver import SolverTrainerConfig, make_solver_trainer
from mgn_tpu_torch.utils.metrics import MetricsLogger
from tests.torch_support import one_thread  # noqa: F401  (fixture)

torch.set_num_threads(2)

SMALL = dict(mps=1, layer_size=8, hidden_layers=1)
LR = 1e-3

# (kwargs of both packages' strategy class); tests/test_solver_train.py's settings
STRATEGIES = {
    "solver-euler": ("SolverTraining", dict(tstart=0.0, dt=0.01, tstop=0.05, solver="euler")),
    "solver-rk4-remat": ("SolverTraining", dict(tstart=0.0, dt=0.02, tstop=0.06, solver="rk4",
                                                solver_dt=0.01, remat=True)),
    "solver-tsit5": ("SolverTraining", dict(tstart=0.0, dt=0.01, tstop=0.04,
                                            solver="tsit5_adaptive", adaptive_substeps=4,
                                            rtol=1e-3, atol=1e-5)),
    "shooting-euler": ("MultipleShooting", dict(tstart=0.0, dt=0.01, tstop=0.08, interval_size=4,
                                                continuity_term=10.0, solver="euler")),
    "shooting-tsit5": ("MultipleShooting", dict(tstart=0.0, dt=0.01, tstop=0.06,
                                                interval_size=4, solver="tsit5_adaptive",
                                                adaptive_substeps=3, continuity_term=10.0)),
}


def _strategies(name):
    cls, kw = STRATEGIES[name]
    return getattr(JS, cls)(**kw), getattr(TS, cls)(**kw)


def _recorder():
    """Passes the gradient on unchanged and keeps it as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


JAX_OPT = optax.chain(_recorder(), optax.adam(LR))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ds"))
    write_synthetic_tfrecord_dataset(d, num_nodes=40, tl=10, n_train=2, n_valid=1, n_test=1)
    jds = jax_load_dataset(d)
    meta = jds.meta
    jstate, jcfg, jspec = jax_init_state(meta, JaxArgs(norm_steps=0, seed=0, **SMALL), JAX_OPT)
    nb, eb = jax_common_buckets([jds.trajectory(0), jds.trajectory(1)], meta)
    jpreps = [jax_prepare_trajectory(jds.trajectory(i), meta, jspec, nb, eb) for i in range(2)]
    cfg, spec = build_model_config(meta, Args(**SMALL))
    ds = load_dataset(d)
    preps = [prepare_trajectory(ds.trajectory(i), meta, spec, nb, eb, device="cpu")
             for i in range(2)]
    return dict(ds=d, meta=meta, jstate=jstate, jcfg=jcfg, jspec=jspec, jpreps=jpreps, cfg=cfg,
                spec=spec, preps=preps)


def _port_state(jstate):
    params = params_from_jax(_np(jstate.params))
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(params, torch.optim.Adam(leaves, lr=LR), norm_from_jax(_np(jstate.norm)), 0)


def _grad_close(got, ref):
    """PERF.md §2's training tolerance, per leaf: at most 1 % of entries
    outside rtol 5e-4 / atol 5e-4 x max(1, max |ref|), relative L2 <= 2e-3."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        a, b = a.detach().numpy().astype(np.float64), np.asarray(b, np.float64)
        scale = max(1.0, float(np.abs(b).max()))
        bad = float(np.mean(np.abs(a - b) > 5e-4 * (np.abs(b) + scale)))
        rel = float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)
        assert bad <= 1e-2 and rel <= 2e-3, (bad, rel)


def _run_jax(setup, strategy, n, union=False, norm_steps=0):
    tr = jax.jit(jax_make_solver_trainer(
        JaxSolverConfig(model=setup["jcfg"], spec=setup["jspec"], strategy=strategy,
                        norm_steps=norm_steps), JAX_OPT))
    if union:
        tm, fields, times, _ = jax_union_prepared(setup["jpreps"])
    else:
        p = setup["jpreps"][0]
        tm, fields, times = p.template, p.fields, p.times
    st, out = setup["jstate"], []
    for i in range(n):
        st, loss = tr(st, tm, fields, times, jax.random.PRNGKey(i))
        out.append((float(loss), st))
    return out


def _run_port(setup, strategy, n, union=False, norm_steps=0):
    step = make_solver_trainer(SolverTrainerConfig(setup["cfg"], setup["spec"], strategy,
                                                   norm_steps=norm_steps))
    if union:
        tm, fields, times, _ = union_prepared(setup["preps"])
    else:
        p = setup["preps"][0]
        tm, fields, times = p.template, p.fields, p.times
    state = _port_state(setup["jstate"])
    out = []
    for _ in range(n):
        _, loss = step(state, tm, fields, times)
        out.append((float(loss[0]), [None if p.grad is None else p.grad.clone()
                                  for p in param_leaves(state.params)]))
    return state, out


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_solver_steps_match_jax(setup, name):
    """Three steps from the same parameters: each step's loss within rtol
    1e-4, the first step's whole-model gradient within the training
    tolerance, the parameters after three Adam steps within rtol 1e-3."""
    jstrat, tstrat = _strategies(name)
    ref = _run_jax(setup, jstrat, 3)
    state, got = _run_port(setup, tstrat, 3)
    assert state.step == 3
    np.testing.assert_allclose([x[0] for x in got], [x[0] for x in ref], rtol=1e-4)
    _grad_close(got[0][1], jax.tree.leaves(ref[0][1].opt_state[0]))
    for a, b in zip(param_leaves(state.params), jax.tree.leaves(ref[-1][1].params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)


def test_union_solver_step_matches_jax(setup):
    """B = 2 trajectories as one disjoint-union graph: one Euler solver step
    against the JAX trainer on the JAX package's union."""
    jstrat, tstrat = _strategies("solver-euler")
    ref = _run_jax(setup, jstrat, 1, union=True)
    _, got = _run_port(setup, tstrat, 1, union=True)
    np.testing.assert_allclose(got[0][0], ref[0][0], rtol=1e-4)
    _grad_close(got[0][1], jax.tree.leaves(ref[0][1].opt_state[0]))
    single = _run_port(setup, tstrat, 1)[1][0][0]
    assert abs(got[0][0] - single) > 1e-6  # the union's loss is over both graphs


@pytest.mark.parametrize("name", ["solver-euler", "shooting-tsit5"])
def test_remat_gives_the_bits_of_no_remat(setup, name, one_thread):
    """remat=True recomputes each substep's forward in the backward; on the
    CPU the loss and every gradient are the bits of remat=False."""
    cls, kw = STRATEGIES[name]
    runs = [_run_port(setup, getattr(TS, cls)(**dict(kw, remat=r)), 1)[1][0] for r in (1, 0)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_warmup_gate_holds_parameters_and_adam_state(setup):
    """During the warm-up (step < norm_steps) the parameters and Adam's
    state stay as they were; the normalizers accumulate as JAX's do."""
    jstrat, tstrat = _strategies("shooting-euler")
    ref = _run_jax(setup, jstrat, 1, norm_steps=2)
    state, got = _run_port(setup, tstrat, 1, norm_steps=2)
    jst = ref[0][1]
    assert state.step == int(jst.step) == 1
    np.testing.assert_allclose(got[0][0], ref[0][0], rtol=1e-4)
    for a, b in zip(param_leaves(state.params), jax.tree.leaves(setup["jstate"].params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert state.optimizer.state_dict()["state"] == {}
    for key, jn in (("node", jst.norm.node["velocity"]), ("output", jst.norm.output["velocity"])):
        tn = getattr(state.norm, key)["velocity"]
        for f in ("acc_count", "num_accumulations", "acc_sum", "acc_sum_sq"):
            np.testing.assert_allclose(getattr(tn, f).numpy(), np.asarray(getattr(jn, f)),
                                       rtol=1e-5, atol=1e-6)
    for f in ("num_accumulations", "acc_sum", "acc_sum_sq"):
        np.testing.assert_allclose(getattr(state.norm.edge, f).numpy(),
                                   np.asarray(getattr(jst.norm.edge, f)), rtol=1e-5,
                                   atol=1e-5)  # a sum that cancels to about 0


def test_divergence_guard_skips_the_update(setup):
    """A NaN frame: the loss is not finite, the parameters and Adam's state
    (moments and count) stay, and the step advances."""
    _, tstrat = _strategies("solver-euler")
    step = make_solver_trainer(SolverTrainerConfig(setup["cfg"], setup["spec"], tstrat,
                                                   norm_steps=0))
    p = setup["preps"][0]
    state = _port_state(setup["jstate"])
    step(state, p.template, p.fields, p.times)  # a finite step: Adam's state exists
    before = [t.detach().clone() for t in param_leaves(state.params)]
    adam = {i: {k: v.clone() for k, v in s.items()}
            for i, s in state.optimizer.state_dict()["state"].items()}
    fields = {k: v.clone() for k, v in p.fields.items()}
    fields["velocity"][2, 5] = float("nan")
    _, loss = step(state, p.template, fields, p.times)
    assert loss.shape == (1,) and not torch.isfinite(loss).any() and state.step == 2
    for a, b in zip(param_leaves(state.params), before):
        assert torch.equal(a.detach(), b)
    after = state.optimizer.state_dict()["state"]
    for i, s in adam.items():
        for k, v in s.items():
            assert torch.equal(after[i][k], v)


RUN = dict(seed=0, norm_steps=1, checkpoint=3, solver_valid="euler", **SMALL)


def _train_records(stream: io.StringIO, kind: str):
    return [r for r in map(json.loads, stream.getvalue().splitlines()) if r["kind"] == kind]


def test_train_network_solver_matches_jax(setup, tmp_path):
    """train_network(SolverTraining), 4 steps over the two training
    trajectories with one validation sweep, from the JAX package's initial
    state: the same losses, validation loss and parameters."""
    strat = dict(tstart=0.0, dt=0.01, tstop=0.05)
    jlog = io.StringIO()
    jstate, jbest = jax_train_network(0.0, optax.adam(LR), setup["ds"], str(tmp_path / "jax"),
                                      metrics=JaxMetricsLogger(stream=jlog), steps=4,
                                      training_strategy=JS.SolverTraining(**strat), **RUN)
    jstate0, _, _ = jax_init_state(setup["meta"], JaxArgs(**RUN).resolve_auto(), optax.adam(LR))
    cp = str(tmp_path / "port")
    save_train_state_from_jax(_np(jstate0), cp)
    log = MetricsLogger(quiet=True)
    state, best = mgn_tpu_torch.train_network(
        0.0, lambda ps: torch.optim.Adam(ps, lr=LR), setup["ds"], cp, metrics=log,
        device="cpu", steps=4, training_strategy=mgn_tpu_torch.SolverTraining(**strat), **RUN)
    got = [r for r in log.records if r["kind"] == "train"]
    ref = _train_records(jlog, "train")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [1, 2, 3, 4]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], rtol=1e-4)
    valid = [r["loss"] for r in log.records if r["kind"] == "valid"]
    assert len(valid) == 1 and len(_train_records(jlog, "valid")) == 1
    np.testing.assert_allclose(valid, [r["loss"] for r in _train_records(jlog, "valid")],
                               rtol=1e-4)
    np.testing.assert_allclose(best, jbest, rtol=1e-4)
    for a, b in zip(param_leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("batchsize", [1, 2])
def test_train_network_solver_resume_k_plus_k_equals_2k(setup, tmp_path, batchsize):
    """MultipleShooting through train_network: 4 steps at once, and 2 then
    2 more after a resume, give the same parameters and Adam state; at
    batchsize 2 each step is one union of both training trajectories."""
    run = dict(RUN, batchsize=batchsize, training_strategy=mgn_tpu_torch.MultipleShooting(
        tstart=0.0, dt=0.01, tstop=0.06, interval_size=4, continuity_term=10.0))
    adam = lambda ps: torch.optim.Adam(ps, lr=LR)  # noqa: E731
    once, _ = mgn_tpu_torch.train_network(0.0, adam, setup["ds"], str(tmp_path / "a"),
                                          device="cpu", steps=4, **run)
    mgn_tpu_torch.train_network(0.0, adam, setup["ds"], str(tmp_path / "b"), device="cpu",
                                steps=2, **run)
    log = MetricsLogger(quiet=True)
    twice, _ = mgn_tpu_torch.train_network(0.0, adam, setup["ds"], str(tmp_path / "b"),
                                           metrics=log, device="cpu", steps=4, **run)
    assert [r["step"] for r in log.records if r["kind"] == "resume"] == [2]
    assert twice.step == once.step == 4
    for a, b in zip(param_leaves(twice.params), param_leaves(once.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sa, sb = twice.optimizer.state_dict()["state"], once.optimizer.state_dict()["state"]
    for i in sa:
        torch.testing.assert_close(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"], rtol=0, atol=0)


def test_cloth_dataset_refuses_solver_strategies(tmp_path):
    """The cloth family trains with derivative training only, as in mgn_tpu."""
    from mgn_tpu_torch.data.synthetic import write_flag_tfrecord_dataset
    ds = str(tmp_path / "flag")
    write_flag_tfrecord_dataset(ds, tl=5, n_train=1, n_valid=1, n_test=0)
    with pytest.raises(ValueError, match="DerivativeTraining"):
        mgn_tpu_torch.train_network(0.0, lambda ps: torch.optim.Adam(ps), ds,
                                    str(tmp_path / "cp"), device="cpu", steps=2,
                                    training_strategy=mgn_tpu_torch.SolverTraining(0.0, 0.02,
                                                                                   0.06),
                                    **SMALL)
