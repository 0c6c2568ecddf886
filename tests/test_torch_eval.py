"""Port: the evaluation surface — ``eval_network`` (single edge set and
cloth), ``rollout_error_report`` and ``export_rollouts_h5`` — on port
checkpoints converted from JAX ones, against ``mgn_tpu.eval_network`` on the
CPU.  Rollouts within the serving tests' tolerance (rtol 1e-4, atol 1e-4).
Without ``h5py`` the export is ``trajectories.npz``, the .h5 export's
arrays bit for bit."""

import io
import os
import sys

import h5py
import jax
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import eval_network as jax_eval_network
from mgn_tpu.api import init_state as jax_init_state
from mgn_tpu.api import train_network as jax_train_network
from mgn_tpu.api_cloth import init_cloth_state as jax_init_cloth_state
from mgn_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.rollout.evaluate import rollout_error_report as jax_rollout_error_report
from mgn_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
import mgn_tpu_torch
from mgn_tpu_torch import api, api_cloth
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import save_checkpoint_from_jax
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.synthetic import (write_flag_tfrecord_dataset,
                                          write_synthetic_tfrecord_dataset)
from mgn_tpu_torch.rollout.evaluate import rollout_error_report
from mgn_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(2)

SMALL = dict(mps=2, layer_size=16, hidden_layers=1)
TOL = dict(rtol=1e-4, atol=1e-4)
DT = 0.01


def _online_from(norm, x):
    """An Online normalizer's accumulators filled from data rows."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    return norm.replace(acc_count=np.float32(1.0), num_accumulations=np.float32(len(x)),
                        acc_sum=x.sum(0).astype(np.float32),
                        acc_sum_sq=(x * x).sum(0).astype(np.float32))


def _convert(jax_cp, state, torch_cp):
    model = JaxCheckpointManager(jax_cp).restore_model(JaxCheckpointManager.model_subtree(state))
    save_checkpoint_from_jax(jax.tree.map(np.asarray, model), torch_cp)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A channel-flow dataset with two test trajectories, and one model as a
    JAX checkpoint and as its port conversion (normalizers filled from the
    data)."""
    root = tmp_path_factory.mktemp("eval")
    ds = str(root / "ds")
    write_synthetic_tfrecord_dataset(ds, num_nodes=60, tl=8, n_train=1, n_valid=1, n_test=2,
                                     dt=DT, seed=0)
    data = load_dataset(ds, is_training=False)
    t = data.trajectory(0)
    vel = t.fields["velocity"]
    state, _, _ = jax_init_state(data.meta, JaxArgs(seed=3, **SMALL), optax.sgd(1.0))
    rel = t.mesh_pos[t.cells[:, 0]] - t.mesh_pos[t.cells[:, 1]]
    mef = np.concatenate([rel, np.linalg.norm(rel, axis=1, keepdims=True)], 1)
    norm = state.norm.replace(
        edge=_online_from(state.norm.edge, mef),
        node={**state.norm.node, "velocity": _online_from(state.norm.node["velocity"], vel)},
        output={"velocity": _online_from(state.norm.output["velocity"],
                                         np.diff(vel, axis=0) / DT)})
    state = state.replace(norm=jax.tree.map(np.asarray, norm))
    jax_cp, torch_cp = str(root / "cp_jax"), str(root / "cp_torch")
    JaxCheckpointManager(jax_cp).save(state, loss=0.0)
    _convert(jax_cp, state, torch_cp)
    return dict(root=root, ds=ds, jax_cp=jax_cp, torch_cp=torch_cp)


def _same_reports(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert list(g["horizons"]) == list(r["horizons"])
        for k, h in r["horizons"].items():
            for name in ("mse", "cum_mse", "cum_rmse"):
                np.testing.assert_allclose(g["horizons"][k][name], h[name], **TOL)
        np.testing.assert_allclose(g["mse_t"], np.asarray(r["mse_t"]), **TOL)
        np.testing.assert_allclose(g["error"], np.asarray(r["error"]), **TOL)
        np.testing.assert_allclose(g["final_rmse"], r["final_rmse"], **TOL)
        assert g["rollout_seconds"] > 0 and g["steps_per_second"] > 0


def _same_exports(got_path, ref_path):
    with h5py.File(got_path, "r") as g, h5py.File(ref_path, "r") as r:
        assert sorted(g) == sorted(r)
        for grp in r:
            assert sorted(g[grp]) == sorted(r[grp])
            for k in r[grp]:
                a, b = np.asarray(g[grp][k]), np.asarray(r[grp][k])
                assert a.shape == b.shape and a.dtype == b.dtype, (grp, k)
                if k in ("prediction", "error"):
                    np.testing.assert_allclose(a, b, **TOL, err_msg=f"{grp}/{k}")
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f"{grp}/{k}")


# (kwargs, the export's solver directory)
EVALS = {
    "euler": (dict(solver="euler", mse_steps=(1, 3, 7, 50)), "euler"),
    "tsit5_adaptive": (dict(solver="tsit5_adaptive", mse_steps=(2, 5)), "tsit5_adaptive"),
    "window_dt": (dict(solver="euler", start=0.02, stop=0.055, dt=0.005, mse_steps=(1, 2)),
                  "euler_dt0.005"),
    "saves": (dict(solver="euler", saves=np.array([0.01, 0.025, 0.04, 0.06], np.float32),
                   mse_steps=(3,)), "euler"),
}


@pytest.mark.parametrize("name", list(EVALS))
def test_eval_network_matches_jax(case, name, tmp_path):
    kwargs, solver_dir = EVALS[name]
    ref = jax_eval_network(case["ds"], case["jax_cp"], str(tmp_path / "jax"),
                           metrics=JaxMetricsLogger(stream=io.StringIO()), **kwargs, **SMALL)
    log = MetricsLogger(quiet=True)
    got = mgn_tpu_torch.eval_network(case["ds"], case["torch_cp"], str(tmp_path / "port"),
                                     metrics=log, device="cpu", **kwargs, **SMALL)
    assert len(got) == 2  # the test split's two trajectories (num_rollouts 10)
    _same_reports(got, ref)
    assert [r["kind"] for r in log.records] == ["eval", "eval", "export"]
    path = log.records[-1]["path"]
    assert path == os.path.join(str(tmp_path / "port"), solver_dir, "trajectories.h5")
    _same_exports(path, os.path.join(str(tmp_path / "jax"), solver_dir, "trajectories.h5"))


def test_eval_rollouts_are_what_eval_network_exports(case, tmp_path):
    """The rollout half alone (what chip_smoke.py runs on the card, which
    has no h5py): the reports and records eval_network writes."""
    kwargs = dict(solver="euler", mse_steps=(2,), num_rollouts=1, **SMALL)
    reports, exports, name = api.eval_rollouts(case["ds"], case["torch_cp"], device="cpu",
                                               **kwargs)
    assert name == "euler" and len(reports) == len(exports) == 1
    again = mgn_tpu_torch.eval_network(case["ds"], case["torch_cp"], str(tmp_path), device="cpu",
                                       **kwargs)
    np.testing.assert_array_equal(reports[0]["error"], again[0]["error"])
    with h5py.File(os.path.join(str(tmp_path), "euler", "trajectories.h5"), "r") as f:
        for k in ("prediction", "gt", "timesteps", "mesh_pos", "cells"):
            np.testing.assert_array_equal(np.asarray(f["0"][k]), exports[0][k])


@pytest.fixture(scope="module")
def cloth_case(tmp_path_factory):
    """A flag dataset with a test split, a 4-step JAX cloth run's checkpoint
    and its port conversion."""
    root = tmp_path_factory.mktemp("eval_cloth")
    ds = str(root / "flag")
    write_flag_tfrecord_dataset(ds, nx=30, ny=20, tl=6, n_train=1, n_valid=1, n_test=1)
    jax_cp, torch_cp = str(root / "cp_jax"), str(root / "cp_torch")
    args = dict(steps=4, norm_steps=2, checkpoint=100, seed=0, **SMALL)
    jax_train_network(0.003, optax.adam(1e-3), ds, jax_cp, **args)
    data = load_dataset(ds)
    state, _, _ = jax_init_cloth_state(data.meta, JaxArgs(**args).resolve_auto(),
                                       optax.sgd(1.0))
    _convert(jax_cp, state, torch_cp)
    return dict(ds=ds, jax_cp=jax_cp, torch_cp=torch_cp)


def test_eval_network_cloth_matches_jax(cloth_case, tmp_path):
    """eval_network on a cloth meta takes the semi-implicit rollout (the
    handles forced from the data) and exports under semi_implicit/; so does
    api_cloth.eval_network_cloth called directly."""
    c = cloth_case
    ref = jax_eval_network(c["ds"], c["jax_cp"], str(tmp_path / "jax"), mse_steps=(1, 3),
                           **SMALL)
    got = mgn_tpu_torch.eval_network(c["ds"], c["torch_cp"], str(tmp_path / "port"),
                                     mse_steps=(1, 3), device="cpu", **SMALL)
    _same_reports(got, ref)
    ref_path = os.path.join(str(tmp_path / "jax"), "semi_implicit", "trajectories.h5")
    _same_exports(os.path.join(str(tmp_path / "port"), "semi_implicit", "trajectories.h5"),
                  ref_path)
    direct = api_cloth.eval_network_cloth(load_dataset(c["ds"], is_training=False),
                                          Args(**SMALL).resolve_auto(), c["torch_cp"],
                                          str(tmp_path / "direct"), (1, 3),
                                          MetricsLogger(quiet=True), torch.device("cpu"))
    _same_reports(direct, ref)
    _same_exports(os.path.join(str(tmp_path / "direct"), "semi_implicit", "trajectories.h5"),
                  ref_path)


def _npz_equals_h5(npz_path, h5_path):
    """The .npz export holds the .h5 export's arrays, bit for bit, under
    ``"<group>/<name>"``."""
    with np.load(npz_path) as z, h5py.File(h5_path, "r") as f:
        keys = sorted(f"{g}/{k}" for g in f for k in f[g])
        assert sorted(z.files) == keys
        for key in keys:
            a, b = z[key], np.asarray(f[key])
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("family", ["mesh", "cloth"])
def test_eval_network_without_h5py_writes_the_same_arrays_as_npz(case, cloth_case, family,
                                                                 tmp_path, monkeypatch):
    """With h5py blocked, eval_network (and its cloth twin) runs to the end and
    writes trajectories.npz, logged as its export record, holding the arrays
    of the trajectories.h5 the same run writes with h5py present."""
    c = case if family == "mesh" else cloth_case
    solver = "euler" if family == "mesh" else "semi_implicit"
    kw = dict(mse_steps=(1, 3), device="cpu", **SMALL,
              **(dict(solver="euler") if family == "mesh" else {}))
    with_h5 = mgn_tpu_torch.eval_network(c["ds"], c["torch_cp"], str(tmp_path / "h5"), **kw)
    monkeypatch.setitem(sys.modules, "h5py", None)
    log = MetricsLogger(quiet=True)
    without = mgn_tpu_torch.eval_network(c["ds"], c["torch_cp"], str(tmp_path / "npz"),
                                         metrics=log, **kw)
    path = os.path.join(str(tmp_path / "npz"), solver, "trajectories.npz")
    assert log.records[-1] == {**log.records[-1], "kind": "export", "path": path}
    assert os.listdir(os.path.dirname(path)) == ["trajectories.npz"]
    monkeypatch.undo()  # h5py back, to read the .h5 export
    for a, b in zip(without, with_h5):
        np.testing.assert_array_equal(a["error"], b["error"])
    _npz_equals_h5(path, os.path.join(str(tmp_path / "h5"), solver, "trajectories.h5"))


def test_eval_network_without_device_raises_without_gpu(case, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        mgn_tpu_torch.eval_network(case["ds"], case["torch_cp"], str(tmp_path), **SMALL)


@pytest.mark.parametrize("kwargs,match", [
    (dict(graph_parallel=2), "torchrun"),
    (dict(graph_parallel=2, halo_rounds=3), "must divide"),
])
def test_eval_network_unported_settings_raise(case, tmp_path, kwargs, match):
    """graph_parallel > 1 runs in a process group of its own ranks: without
    one it names torchrun; a halo_rounds that does not divide mps is refused
    first (spatial_reorder, refused here before, runs:
    tests/test_torch_parallel_partition.py)."""
    with pytest.raises(ValueError, match=match):
        mgn_tpu_torch.eval_network(case["ds"], case["torch_cp"], str(tmp_path), device="cpu",
                                   **SMALL, **kwargs)


def test_rollout_error_report_matches_jax():
    rng = np.random.default_rng(0)
    pred, gt = (rng.normal(size=(9, 14, 3)).astype(np.float32) for _ in range(2))
    got = rollout_error_report(pred, gt, 11, (0, 4, 8, 9))
    ref = jax_rollout_error_report(pred, gt, 11, (0, 4, 8, 9))
    assert list(got["horizons"]) == list(ref["horizons"]) == [0, 4, 8]
    assert got["horizons"] == ref["horizons"] and got["final_rmse"] == ref["final_rmse"]
    np.testing.assert_array_equal(got["error"], ref["error"])
    np.testing.assert_array_equal(got["mse_t"], ref["mse_t"])
    assert got["error"].shape == (9, 11, 3)
