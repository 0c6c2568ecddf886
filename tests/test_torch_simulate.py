"""Port: the whole serving slice — ``mgn_tpu_torch.simulate`` on a port
checkpoint converted from an orbax one, against ``mgn_tpu.api.simulate``."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import init_state, simulate as jax_simulate
from mgn_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.data.synthetic import make_channel_mesh, make_trajectory, synthetic_meta
import mgn_tpu_torch
from mgn_tpu_torch.convert import save_checkpoint_from_jax

torch.set_num_threads(2)

SMALL = dict(mps=3, layer_size=32, hidden_layers=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _online_from(norm, x):
    """Fill an Online normalizer's accumulators from data rows (as training
    would after warm-up); fresh accumulators divide by std_epsilon."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    return norm.replace(acc_count=np.float32(1.0), num_accumulations=np.float32(len(x)),
                        acc_sum=x.sum(0).astype(np.float32),
                        acc_sum_sq=(x * x).sum(0).astype(np.float32))


@pytest.fixture(scope="module")
def serving_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
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
        edge=_online_from(state.norm.edge, mef),
        node={**state.norm.node, "velocity": _online_from(state.norm.node["velocity"], vel)},
        output={"velocity": _online_from(state.norm.output["velocity"],
                                         np.diff(vel, axis=0) / dt)})
    state = state.replace(norm=jax.tree.map(lambda a: np.asarray(a), norm))
    jax_cp = str(root / "cp_jax")
    JaxCheckpointManager(jax_cp).save(state, loss=0.0)

    model = JaxCheckpointManager(jax_cp).restore_model(
        JaxCheckpointManager.model_subtree(state))
    torch_cp = str(root / "cp_torch")
    save_checkpoint_from_jax(jax.tree.map(np.asarray, model), torch_cp)
    times = (np.arange(6) * dt).astype(np.float32)  # 5 Euler steps
    return dict(root=str(root), jax_cp=jax_cp, torch_cp=torch_cp, pos=pos, cells=cells,
                node_type=node_type, f0={"velocity": vel[0]}, times=times)


def test_simulate_matches_jax(serving_case):
    c = serving_case
    ref = jax_simulate(c["root"], c["jax_cp"], c["pos"], c["node_type"], c["f0"], c["times"],
                       cells=c["cells"], **SMALL)
    out = mgn_tpu_torch.simulate(c["root"], c["torch_cp"], c["pos"], c["node_type"], c["f0"],
                                 c["times"], cells=c["cells"], device="cpu", **SMALL)
    assert out.shape == ref.shape == (6, len(c["pos"]), 2)
    assert np.isfinite(out).all()
    assert np.abs(out[-1] - out[0]).max() > 1e-3  # the state really evolved
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_simulate_without_device_raises_without_gpu(serving_case):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    c = serving_case
    with pytest.raises(RuntimeError, match="CUDA"):
        mgn_tpu_torch.simulate(c["root"], c["torch_cp"], c["pos"], c["node_type"], c["f0"],
                               c["times"], cells=c["cells"], **SMALL)


@pytest.mark.parametrize("kwargs,match", [(dict(graph_parallel=2, halo_rounds=2), "must divide"),
                                          (dict(graph_parallel=2), "torchrun")])
def test_unported_settings_raise(serving_case, kwargs, match):
    """graph_parallel > 1 without a process group of its ranks names
    torchrun; a halo_rounds that does not divide mps is refused first
    (spatial_reorder, refused here before, runs:
    tests/test_torch_parallel_partition.py)."""
    c = serving_case
    with pytest.raises(ValueError, match=match):
        mgn_tpu_torch.simulate(c["root"], c["torch_cp"], c["pos"], c["node_type"], c["f0"],
                               c["times"], cells=c["cells"], device="cpu", **SMALL, **kwargs)


def test_adaptive_solver_not_ported_yet(serving_case):
    """The adaptive Tsit5 solver, which raised before it was ported (ROADMAP
    C9), now serves: simulate(solver="tsit5_adaptive") on the converted
    weights against mgn_tpu.simulate with the same solver (rtol/atol from
    Args in both)."""
    c = serving_case
    ref = jax_simulate(c["root"], c["jax_cp"], c["pos"], c["node_type"], c["f0"], c["times"],
                       cells=c["cells"], solver="tsit5_adaptive", **SMALL)
    out = mgn_tpu_torch.simulate(c["root"], c["torch_cp"], c["pos"], c["node_type"], c["f0"],
                                 c["times"], cells=c["cells"], solver="tsit5_adaptive",
                                 device="cpu", **SMALL)
    assert out.shape == ref.shape == (6, len(c["pos"]), 2)
    assert np.isfinite(out).all() and np.abs(out[-1] - out[0]).max() > 1e-3
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_cloth_meta_raises(tmp_path):
    meta = synthetic_meta(tl=4, n_train=1, n_valid=1)
    meta["world_edges"] = {"radius": 0.05, "capacity_per_node": 4}
    with open(tmp_path / "meta.json", "w") as f:
        json.dump(meta, f)
    pos, cells, nt = make_channel_mesh(50, seed=0)
    with pytest.raises(ValueError, match="cloth"):
        mgn_tpu_torch.simulate(str(tmp_path), str(tmp_path / "cp"), pos, nt,
                               {"velocity": np.zeros((50, 2))}, np.arange(3) * 0.01,
                               cells=cells, device="cpu")


def test_import_pulls_in_no_jax():
    """Every module of the port, and chip_smoke.py, import without JAX, flax,
    optax, orbax, h5py or anything of mgn_tpu (conftest has imported JAX in
    this process, so the check runs in a fresh one)."""
    code = ("import importlib, pkgutil, sys, mgn_tpu_torch, chip_smoke\n"
            "names = [m.name for m in pkgutil.walk_packages(mgn_tpu_torch.__path__, "
            "'mgn_tpu_torch.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'h5py', 'mgn_tpu')))\n"
            "print(sorted(names))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    banned, names = out.stdout.strip().splitlines()
    assert banned == "[]", out.stdout + out.stderr
    # the training slice's modules are among those imported
    for mod in ("train.derivative", "utils.metrics", "data.tfrecord", "data.tfrecord_writer",
                "data.pipeline", "checkpoint.manager", "convert", "api"):
        assert f"'mgn_tpu_torch.{mod}'" in names, names
