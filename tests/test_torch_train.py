"""Port: the training slice — normalizer accumulation, the derivative
trainer, ``train_network`` and checkpoint resume — against the JAX package
(``optax.adam`` against ``torch.optim.Adam``) on the CPU, f32, noise 0 where
values are compared (the two packages draw different random numbers)."""

import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import init_state as jax_init_state
from mgn_tpu.api import train_network as jax_train_network
from mgn_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.core import normalizers as JN
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.prep import common_buckets as jax_common_buckets
from mgn_tpu.data.prep import prepare_trajectory as jax_prepare_trajectory
from mgn_tpu.train.derivative import DerivativeTrainerConfig as JaxTrainerConfig
from mgn_tpu.train.derivative import make_derivative_trainer as jax_make_trainer
from mgn_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
import mgn_tpu_torch
from mgn_tpu_torch.api import build_model_config
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import (adam_state_from_jax, norm_from_jax, params_from_jax,
                                   save_train_state_from_jax)
from mgn_tpu_torch.core import normalizers as TN
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.prep import prepare_trajectory
from mgn_tpu_torch.data.synthetic import write_synthetic_tfrecord_dataset
from mgn_tpu_torch.train.common import TrainState, param_leaves, type_mask
from mgn_tpu_torch.train.derivative import (DerivativeTrainerConfig, frame_inputs,
                                            make_derivative_trainer)
from mgn_tpu_torch.train.strategies import SolverTraining
from mgn_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(2)

SMALL = dict(mps=2, layer_size=16, hidden_layers=1)
RUN = dict(seed=0, norm_steps=3, checkpoint=5, solver_valid="euler", **SMALL)
TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ds"))
    write_synthetic_tfrecord_dataset(d, num_nodes=60, tl=6, n_train=2, n_valid=1, n_test=0)
    return d


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_params(port_params, jax_params):
    got, ref = param_leaves(port_params), jax.tree.leaves(jax_params)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def _records(stream: io.StringIO, kind: str):
    return [r for r in map(json.loads, stream.getvalue().splitlines()) if r["kind"] == kind]


def test_online_update_and_accumulate_match_jax():
    rng = np.random.default_rng(0)
    jn, tn = JN.Online.create(3, max_acc=2.0), TN.Online.create(3, max_acc=2.0)
    for _ in range(3):  # the third call is past the cap: a no-op
        x = rng.normal(size=(20, 3)).astype(np.float32)
        m = rng.random(20) > 0.3
        jn = JN.accumulate(jn, jnp.asarray(x), jnp.asarray(m))
        tn = TN.accumulate(tn, torch.from_numpy(x), torch.from_numpy(m))
        for f in ("acc_count", "num_accumulations", "acc_sum", "acc_sum_sq"):
            np.testing.assert_allclose(getattr(tn, f).numpy(), np.asarray(getattr(jn, f)),
                                       rtol=1e-6, atol=1e-6)
    assert float(tn.acc_count) == 2.0
    np.testing.assert_allclose(tn.std.numpy(), np.asarray(jn.std), rtol=1e-5)
    mm = TN.OfflineMinMax.create(0.0, 1.0)
    assert TN.accumulate(mm, torch.ones(4, 1)) is mm
    tree = TN.accumulate_tree({"a": TN.Online.create(1), "b": mm},
                              {"a": torch.ones(5, 1), "c": torch.ones(5, 1)})
    assert float(tree["a"].num_accumulations) == 5.0 and tree["b"] is mm


def test_derivative_trainer_matches_jax(ds_dir):
    """4 steps from identical parameters, noise 0, norm_steps 2: two warm-up
    steps (normalizers only) and two Adam updates."""
    jds = jax_load_dataset(ds_dir)
    meta = jds.meta
    args = JaxArgs(seed=0, norm_steps=2, **SMALL).resolve_auto()
    opt = optax.adam(LR)
    jstate, jcfg, jspec = jax_init_state(meta, args, opt)
    nb, eb = jax_common_buckets([jds.trajectory(0)], meta)
    jprep = jax_prepare_trajectory(jds.trajectory(0), meta, jspec, nb, eb)
    perm = [3, 0, 4, 1]
    jtrain = jax.jit(jax_make_trainer(
        JaxTrainerConfig(model=jcfg, spec=jspec, noise_stddevs=(0.0,), norm_steps=2), opt))
    jst, jlosses = jtrain(jstate, jprep.template, jprep.fields, jprep.times,
                          jnp.asarray(perm, jnp.int32), jax.random.PRNGKey(0))

    cfg, spec = build_model_config(meta, Args(**SMALL))
    params = params_from_jax(_np(jstate.params))
    for p in param_leaves(params):
        p.requires_grad_(True)
    state = TrainState(params, _adam(param_leaves(params)), norm_from_jax(_np(jstate.norm)), 0)
    prep = prepare_trajectory(load_dataset(ds_dir).trajectory(0), meta, spec, nb, eb)
    train = make_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.0,), norm_steps=2))
    state, losses = train(state, prep.template, prep.fields, prep.times, perm,
                          torch.Generator().manual_seed(0))
    assert state.step == int(jst.step) == 4
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    _close_params(state.params, jst.params)
    for f in ("acc_sum", "acc_sum_sq", "num_accumulations"):
        np.testing.assert_allclose(getattr(state.norm.output["velocity"], f).numpy(),
                                   np.asarray(getattr(jst.norm.output["velocity"], f)),
                                   rtol=1e-5, atol=1e-5)
    # the optimizer advanced only on the two updates, as optax's state does
    ours = state.optimizer.state_dict()["state"]
    ref = adam_state_from_jax(_np(jst.opt_state))
    assert float(ours[0]["step"]) == float(ref[0]["step"]) == 2.0
    for i in ref:
        torch.testing.assert_close(ours[i]["exp_avg"], ref[i]["exp_avg"], **TOL)


def test_noise_only_on_noisy_types(ds_dir):
    meta = load_dataset(ds_dir).meta
    cfg, spec = build_model_config(meta, Args(**SMALL))
    prep = prepare_trajectory(load_dataset(ds_dir).trajectory(0), meta, spec)
    tcfg = DerivativeTrainerConfig(cfg, spec, (0.5,), types_noisy=(0,))
    noisy = type_mask(prep.template.node_type, (0,)) & prep.template.node_mask
    u, targets = frame_inputs(tcfg, prep.fields, prep.times, 2, noisy,
                              torch.Generator().manual_seed(1))
    clean = prep.fields["velocity"][2]
    moved = (u["velocity"] != clean).any(dim=-1)
    assert moved[noisy].all() and not moved[~noisy].any()
    dt = prep.times[3] - prep.times[2]
    torch.testing.assert_close(targets["velocity"],
                               (prep.fields["velocity"][3] - u["velocity"]) / dt)


@pytest.fixture(scope="module")
def jax_run(ds_dir, tmp_path_factory):
    """mgn_tpu.train_network, 10 steps from scratch (two 5-frame windows,
    norm_steps 3, a checkpoint and a validation sweep after each window)."""
    cp = str(tmp_path_factory.mktemp("cp_jax"))
    log = io.StringIO()
    state, best = jax_train_network(0.0, optax.adam(LR), ds_dir, cp,
                                    metrics=JaxMetricsLogger(stream=log), steps=10, **RUN)
    return dict(cp=cp, state=state, best=best, log=log)


def test_train_network_visits_the_same_frames_as_jax(ds_dir, jax_run, tmp_path):
    """Started from the JAX package's initial state (converted), the port's
    train_network draws the same frames and reaches the same losses,
    validation losses and parameters."""
    meta = jax_load_dataset(ds_dir).meta
    jstate0, _, _ = jax_init_state(meta, JaxArgs(**RUN).resolve_auto(), optax.adam(LR))
    cp = str(tmp_path / "cp")
    save_train_state_from_jax(_np(jstate0), cp)
    log = MetricsLogger(quiet=True)
    state, best = mgn_tpu_torch.train_network(0.0, _adam, ds_dir, cp, metrics=log,
                                              device="cpu", steps=10, **RUN)
    ref = _records(jax_run["log"], "train")
    got = [r for r in log.records if r["kind"] == "train"]
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [5, 10]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], **TOL)
    ref_valid = _records(jax_run["log"], "valid")
    got_valid = [r for r in log.records if r["kind"] == "valid"]
    assert len(got_valid) == len(ref_valid) == 2
    np.testing.assert_allclose([r["loss"] for r in got_valid], [r["loss"] for r in ref_valid],
                               **TOL)
    np.testing.assert_allclose(best, jax_run["best"], **TOL)
    _close_params(state.params, jax_run["state"].params)


def test_resume_k_plus_k_equals_2k(ds_dir, tmp_path):
    once, _ = mgn_tpu_torch.train_network(0.0, _adam, ds_dir, str(tmp_path / "a"),
                                          device="cpu", steps=10, **RUN)
    mgn_tpu_torch.train_network(0.0, _adam, ds_dir, str(tmp_path / "b"), device="cpu",
                                steps=5, **RUN)
    log = MetricsLogger(quiet=True)
    twice, _ = mgn_tpu_torch.train_network(0.0, _adam, ds_dir, str(tmp_path / "b"),
                                           metrics=log, device="cpu", steps=10, **RUN)
    assert [r["step"] for r in log.records if r["kind"] == "resume"] == [5]
    assert twice.step == once.step == 10
    for a, b in zip(param_leaves(twice.params), param_leaves(once.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sa, sb = twice.optimizer.state_dict()["state"], once.optimizer.state_dict()["state"]
    for i in sa:
        torch.testing.assert_close(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"], rtol=0, atol=0)


def test_converted_jax_train_state_resumes_in_the_port(ds_dir, jax_run, tmp_path):
    """The JAX run's step-5 checkpoint, resumed by the JAX package and, after
    conversion, by the port: the same next window and parameters."""
    meta = jax_load_dataset(ds_dir).meta
    cp_j = str(tmp_path / "cp_jax5")
    shutil.copytree(f"{jax_run['cp']}/step_5", f"{cp_j}/step_5")
    jstate0, _, _ = jax_init_state(meta, JaxArgs(**RUN).resolve_auto(), optax.adam(LR))
    jstate5, _ = JaxCheckpointManager(cp_j).restore(jstate0)
    assert int(jstate5.step) == 5
    cp_t = str(tmp_path / "cp_torch")
    save_train_state_from_jax(_np(jstate5), cp_t)
    jlog = io.StringIO()
    jstate, _ = jax_train_network(0.0, optax.adam(LR), ds_dir, cp_j,
                                  metrics=JaxMetricsLogger(stream=jlog), steps=10, **RUN)
    log = MetricsLogger(quiet=True)
    state, _ = mgn_tpu_torch.train_network(0.0, _adam, ds_dir, cp_t, metrics=log,
                                           device="cpu", steps=10, **RUN)
    got = [r["loss"] for r in log.records if r["kind"] == "train"]
    np.testing.assert_allclose(got, [r["loss"] for r in _records(jlog, "train")], **TOL)
    _close_params(state.params, jstate.params)


def test_train_network_without_device_raises_without_gpu(ds_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        mgn_tpu_torch.train_network(0.0, _adam, ds_dir, str(tmp_path), steps=5, **RUN)


def test_train_network_with_default_args_trains_and_validates(ds_dir, tmp_path):
    """Default Args validate with the adaptive Tsit5 rollout
    (solver_valid="tsit5_adaptive"), which raised before the first step
    until it was ported (ROADMAP C9): small widths, the CPU, a few steps and
    two validation sweeps, finite losses, a best checkpoint."""
    assert Args().solver_valid == "tsit5_adaptive"
    stream = io.StringIO()
    state, best = mgn_tpu_torch.train_network(
        0.0, _adam, ds_dir, str(tmp_path), device="cpu", steps=12, norm_steps=3, checkpoint=4,
        metrics=MetricsLogger(stream=stream), **SMALL)
    assert state.step >= 12 and np.isfinite(best)  # whole windows of frames
    valid = _records(stream, "valid")
    assert len(valid) >= 2 and all(np.isfinite(r["loss"]) for r in valid)
    assert _records(stream, "checkpoint")


@pytest.mark.parametrize("kwargs", [
    dict(batchsize=2),
    dict(training_strategy=SolverTraining(tstart=0.0, dt=0.01, tstop=0.05)),
    dict(graph_parallel=2),
])
def test_unported_training_settings_raise(ds_dir, tmp_path, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mgn_tpu_torch.train_network(0.0, _adam, ds_dir, str(tmp_path), device="cpu",
                                    steps=5, **{**RUN, **kwargs})


def test_h5_split_raises_without_importing_h5py(ds_dir, tmp_path):
    d = tmp_path / "h5ds"
    shutil.copytree(ds_dir, d)
    (d / "train.tfrecord").rename(d / "train.h5")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_dataset(str(d))
