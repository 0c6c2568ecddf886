"""Port: ``python -m mgn_tpu_torch`` (``mgn_tpu_torch/__main__.py``) and the
CylinderFlow example twin (``mgn_tpu_torch.examples.cylinder_flow``) on the
CPU (``--device cpu``): ``synth`` writes TFRecord datasets the reader
loads (every family), ``train`` runs each strategy and equals the API call,
``eval`` exports ``trajectories.h5`` where ``h5py`` is installed and
``trajectories.npz`` with ``h5py`` blocked, ``convert`` runs
``mgn_tpu_torch.data.convert``, ``export`` writes an artefact that
``load_simulator`` runs, every command that is not ported raises naming its
ROADMAP item, and the module imports neither JAX nor the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mgn_tpu_torch
from mgn_tpu_torch.__main__ import main
from mgn_tpu_torch.checkpoint.manager import load_model
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data import ns as port_ns
from mgn_tpu_torch.data.convert import inspect as convert_inspect
from mgn_tpu_torch.data.synthetic import (write_airfoil_tfrecord_dataset,
                                          write_plate_tfrecord_dataset,
                                          write_synthetic_tfrecord_dataset)
from mgn_tpu_torch.examples import cylinder_flow
from mgn_tpu_torch.train.common import param_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--mps", "1", "--layer-size", "8", "--hidden-layers", "1", "--seed", "0",
         "--device", "cpu"]


def _cli(*argv):
    """``python -m mgn_tpu_torch`` in a subprocess from the repository root."""
    return subprocess.run([sys.executable, "-m", "mgn_tpu_torch", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli") / "ds")
    r = _cli("synth", d, "--family", "cylinder", "--num-nodes", "60", "--tl", "8",
             "--n-train", "2", "--n-valid", "1", "--n-test", "1")
    assert r.returncode == 0, r.stderr
    assert f"wrote cylinder dataset to {d}" in r.stdout
    return d


def test_synth_writes_what_the_writer_writes(ds_dir, tmp_path):
    """The CLI's cylinder dataset is the TFRecord writer's for the same
    arguments, and the reader loads every split."""
    ref = str(tmp_path / "ref")
    write_synthetic_tfrecord_dataset(ref, num_nodes=60, tl=8, n_train=2, n_valid=1, n_test=1)
    for valid in (False, True):
        a = load_dataset(ds_dir).trajectory(0, valid=valid)
        b = load_dataset(ref).trajectory(0, valid=valid)
        np.testing.assert_array_equal(a.fields["velocity"], b.fields["velocity"])
        np.testing.assert_array_equal(a.mesh_pos, b.mesh_pos)
    assert load_dataset(ds_dir, is_training=False).trajectory(0).fields["velocity"].shape[0] == 8


def test_synth_flag(tmp_path):
    d = str(tmp_path / "flag")
    main(["synth", d, "--family", "flag", "--tl", "5", "--n-train", "1", "--n-valid", "1",
          "--n-test", "0"])
    ds = load_dataset(d)
    assert ds.meta.get("world_edges") and ds.trajectory(0).fields["world_pos"].shape[0] == 5


@pytest.mark.parametrize("family,writer", [("airfoil", write_airfoil_tfrecord_dataset),
                                           ("plate", write_plate_tfrecord_dataset)])
def test_synth_airfoil_and_plate_write_what_the_writers_write(tmp_path, family, writer):
    d, ref = str(tmp_path / "cli"), str(tmp_path / "ref")
    counts = dict(n_train=1, n_valid=1, n_test=1)
    main(["synth", d, "--family", family, "--num-nodes", "48", "--tl", "5", "--n-train", "1",
          "--n-valid", "1", "--n-test", "1"])
    writer(ref, tl=5, **counts, **({"num_nodes": 48} if family == "airfoil" else {}))
    for is_training, valid in ((True, False), (True, True), (False, False)):
        a = load_dataset(d, is_training=is_training).trajectory(0, valid=valid)
        b = load_dataset(ref, is_training=is_training).trajectory(0, valid=valid)
        assert sorted(a.fields) == sorted(b.fields)
        for f in a.fields:
            np.testing.assert_array_equal(a.fields[f], b.fields[f])
        np.testing.assert_array_equal(a.cells, b.cells)


def _small_ns(monkeypatch):
    """The NS solver at a test's size: a 32 x 16 grid, 0.05 of spin-up."""
    solve = port_ns.solve_ns_channel
    monkeypatch.setattr(port_ns, "solve_ns_channel",
                        lambda **kw: solve(**dict(kw, nx=32, ny=16, spin_up=0.05)))


def test_synth_ns_writes_what_the_writer_writes(tmp_path, monkeypatch, capsys):
    _small_ns(monkeypatch)
    d, ref = str(tmp_path / "cli"), str(tmp_path / "ref")
    main(["synth", d, "--family", "ns", "--num-nodes", "120", "--tl", "4", "--n-train", "1",
          "--n-valid", "1", "--n-test", "0"])
    assert f"wrote ns dataset to {d}" in capsys.readouterr().out
    port_ns.write_ns_tfrecord_dataset(ref, num_nodes=120, tl=4, n_train=1, n_valid=1,
                                      n_test=0, verbose=False)
    for valid in (False, True):
        a, b = (load_dataset(x).trajectory(0, valid=valid) for x in (d, ref))
        np.testing.assert_array_equal(a.fields["velocity"], b.fields["velocity"])
        np.testing.assert_array_equal(a.cells, b.cells)


def test_convert_runs_the_convert_module(ds_dir, capsys):
    main(["convert", "inspect", ds_dir])
    cli = capsys.readouterr().out
    convert_inspect(ds_dir)
    assert cli == capsys.readouterr().out and len(cli.splitlines()) == 2


def test_eval_without_h5py_writes_npz(ds_dir, tmp_path, monkeypatch):
    """``eval`` runs to the end where h5py is missing and writes the .npz
    export."""
    cp, out = str(tmp_path / "cp"), str(tmp_path / "out")
    main(["train", ds_dir, cp, "--steps", "2", "--checkpoint", "2", "--norm-steps", "0",
          *SMALL])
    monkeypatch.setitem(sys.modules, "h5py", None)
    main(["eval", ds_dir, cp, out, "--solver", "euler", "--num-rollouts", "1", *SMALL])
    with np.load(os.path.join(out, "euler", "trajectories.npz")) as z:
        assert z["0/prediction"].shape == z["0/gt"].shape == (8, 60, 2)


def test_train_shooting_equals_the_api_then_eval(ds_dir, tmp_path):
    """``train --strategy shooting`` in a subprocess gives the parameters of
    the same train_network call in this process; ``eval`` then writes the
    rollouts' HDF5 export."""
    cp = str(tmp_path / "cp")
    args = ["--strategy", "shooting", "--tstop", "0.04", "--interval-size", "3", "--steps", "3",
            "--checkpoint", "2", "--norm-steps", "1", "--lr", "1e-3"]
    r = _cli("train", ds_dir, cp, *args, *SMALL)
    assert r.returncode == 0, r.stderr
    params, _ = load_model(cp, False, torch.device("cpu"))
    state, _ = mgn_tpu_torch.train_network(
        0.02, lambda ps: torch.optim.Adam(ps, lr=1e-3), ds_dir, str(tmp_path / "api"),
        device="cpu", steps=3, checkpoint=2, norm_steps=1, mps=1, layer_size=8,
        hidden_layers=1, seed=0, training_strategy=mgn_tpu_torch.MultipleShooting(
            0.0, 0.01, 0.04, interval_size=3))
    assert state.step == 3
    for a, b in zip(param_leaves(params), param_leaves(state.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-7)
    out = str(tmp_path / "out")
    r = _cli("eval", ds_dir, cp, out, "--solver", "euler", "--num-rollouts", "1",
             "--mse-steps", "1", "3", *SMALL)
    assert r.returncode == 0, r.stderr
    assert os.path.isfile(os.path.join(out, "euler", "trajectories.h5"))


@pytest.mark.parametrize("strategy", ["derivative", "solver"])
def test_train_strategies(ds_dir, tmp_path, strategy):
    cp = str(tmp_path / "cp")
    main(["train", ds_dir, cp, "--strategy", strategy, "--tstop", "0.03", "--steps", "2",
          "--checkpoint", "2", "--norm-steps", "0", *SMALL])
    assert os.path.isdir(os.path.join(cp, "step_2" if strategy == "solver" else "step_7"))


def test_export_writes_an_artefact_load_simulator_runs(ds_dir, tmp_path):
    """``export`` in a subprocess writes the artefact of export_simulator for
    the test trajectory's mesh; load_simulator runs it to simulate's bits."""
    cp, out = str(tmp_path / "cp"), str(tmp_path / "sim.pt2")
    main(["train", ds_dir, cp, "--steps", "2", "--checkpoint", "2", "--norm-steps", "0",
          *SMALL])
    r = _cli("export", ds_dir, cp, out, "--num-steps", "3", *SMALL)
    assert r.returncode == 0, r.stderr
    size = os.path.getsize(out)
    assert f"wrote {size} bytes to {out} (num_steps=3, solver=euler)" in r.stdout
    tr = load_dataset(ds_dir, is_training=False).trajectory(0)
    with open(out, "rb") as fh:
        pred = mgn_tpu_torch.load_simulator(fh.read(), device="cpu")(tr.times[:3],
                                                                     tr.fields["velocity"][0])
    ref = mgn_tpu_torch.simulate(ds_dir, cp, tr.mesh_pos, tr.node_type,
                                 {"velocity": tr.fields["velocity"][0]}, tr.times[:3],
                                 cells=tr.cells, device="cpu", mps=1, layer_size=8,
                                 hidden_layers=1, seed=0)
    assert pred.shape == (3, tr.mesh_pos.shape[0], 2) and np.array_equal(pred, ref)


@pytest.mark.parametrize("argv,error,match", [
    # the sharded export runs (tests/test_torch_serve_sharded.py): outside torchrun it
    # asks for the process group
    (["export", "DS", "CP", "OUT", "--graph-parallel", "2", "--dist-backend", "gloo",
      "--device", "cpu"], ValueError, "torchrun"),
    (["bench-scaling", "1900", "15"], NotImplementedError, "ROADMAP.md, A1"),
    # graph-parallel solver training runs: outside torchrun it asks for the process group
    (["train", "DS", "CP", "--graph-parallel", "2", "--strategy", "solver"], ValueError,
     "torchrun"),
])
def test_unported_commands_name_their_roadmap_item(ds_dir, tmp_path, argv, error, match):
    argv = [{"DS": ds_dir, "CP": str(tmp_path / "cp"), "OUT": str(tmp_path / "out")}.get(a, a)
            for a in argv]
    with pytest.raises(error, match=match):
        main(argv + (["--device", "cpu"] if argv[0] == "train" else []))


def test_device_defaults_to_cuda(ds_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", ds_dir, str(tmp_path / "cp"), "--steps", "1"])


def test_import_pulls_in_neither_jax_nor_mgn_tpu():
    code = ("import sys, mgn_tpu_torch.__main__, mgn_tpu_torch.examples.cylinder_flow; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mgn_tpu')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_cylinder_flow_example_runs_small(ds_dir, tmp_path):
    """The example's four workflows in order at a tiny size: derivative
    training, solver training (resumed from it), and the Euler and adaptive
    Tsit5 evaluations with their exports."""
    cp, out = str(tmp_path / "cp"), str(tmp_path / "out")
    small = ["--mps", "1", "--layer-size", "8", "--hidden-layers", "1", "--norm-steps", "1",
             "--num-rollouts", "1", "--device", "cpu"]
    cylinder_flow.main(["train-derivative", ds_dir, cp, "--steps", "7", "--checkpoint", "7",
                        *small])
    cylinder_flow.main(["train-solver", ds_dir, cp, "--steps", "9", "--checkpoint", "2",
                        "--tstop", "0.03", *small])
    for mode, name in (("eval-euler", "euler"), ("eval-tsit5", "tsit5_adaptive")):
        cylinder_flow.main([mode, ds_dir, cp, out, "--mse-steps", "1", "3", *small])
        assert os.path.isfile(os.path.join(out, name, "trajectories.h5"))
