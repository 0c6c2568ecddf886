"""Port: the example drivers (``mgn_tpu_torch/examples``: airfoil,
deforming_plate, flag_simple, ns_vortex) on the CPU at a tiny size — each
``main(argv)`` trains with ``--device cpu`` and evaluates the checkpoint,
writing its rollouts' export — and every module of this slice imports in a
process where ``jax``, ``mgn_tpu`` and ``h5py`` cannot be imported."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mgn_tpu_torch.data import ns as port_ns
from mgn_tpu_torch.data.synthetic import (write_airfoil_tfrecord_dataset,
                                          write_flag_tfrecord_dataset,
                                          write_plate_tfrecord_dataset)
from mgn_tpu_torch.examples import airfoil, deforming_plate, flag_simple, ns_vortex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--mps", "1", "--layer-size", "8", "--hidden-layers", "1", "--norm-steps", "1",
        "--num-rollouts", "1", "--device", "cpu"]
COUNTS = dict(n_train=1, n_valid=1, n_test=1)


def _train_and_eval(example, ds, tmp_path, solver_dir="euler"):
    cp, out = str(tmp_path / "cp"), str(tmp_path / "out")
    example.main(["train", ds, cp, "--steps", "3", "--checkpoint", "3", *TINY])
    assert any(d.startswith("step_") for d in os.listdir(cp))
    example.main(["eval", ds, cp, out, "--mse-steps", "1", "2", *TINY])
    path = os.path.join(out, solver_dir, "trajectories.h5")
    assert os.path.isfile(path)
    return cp, out


def test_airfoil_example_trains_and_evaluates(tmp_path, capsys):
    ds = str(tmp_path / "ds")
    write_airfoil_tfrecord_dataset(ds, num_nodes=48, tl=5, **COUNTS)
    _train_and_eval(airfoil, ds, tmp_path)
    assert airfoil.NOISE == (10.0, 0.01) and airfoil.HYPERS["types_updated"] == (0, 5)
    assert "trajectory 0: final_rmse=" in capsys.readouterr().out


def test_deforming_plate_example_trains_and_evaluates(tmp_path):
    ds = str(tmp_path / "ds")
    write_plate_tfrecord_dataset(ds, tl=5, **COUNTS)
    _train_and_eval(deforming_plate, ds, tmp_path)
    assert deforming_plate.NOISE == 0.003 and deforming_plate.HYPERS["types_updated"] == (0, 6)


def test_flag_simple_example_trains_and_evaluates(tmp_path):
    ds = str(tmp_path / "ds")
    write_flag_tfrecord_dataset(ds, nx=30, ny=20, tl=5, **COUNTS)
    cp = str(tmp_path / "cp")
    flag_simple.main(["train", ds, cp, "--steps", "3", "--checkpoint", "3", *TINY])
    flag_simple.main(["eval", ds, cp, "--mse-steps", "1", *TINY])  # out: <cp>_out
    assert os.path.isfile(os.path.join(cp + "_out", "semi_implicit", "trajectories.h5"))
    # graph-parallel: one process a rank, launched by torchrun (tests/test_torch_parallel_cloth.py)
    with pytest.raises(ValueError, match="torchrun"):
        flag_simple.main(["train", ds, cp, "--graph-parallel", "2", *TINY])


def test_ns_vortex_example_synthesises_trains_in_bf16_and_evaluates(tmp_path, monkeypatch):
    ds = str(tmp_path / "ds")
    calls = []
    write = port_ns.write_ns_tfrecord_dataset
    small = dict(num_nodes=120, tl=4, n_train=1, n_valid=1, n_test=1, nx=32, ny=16,
                 spin_up=0.05)

    def write_small(path, **kw):  # the example's sizes asked for, a test's written
        calls.append(kw)
        write(path, verbose=False, **small)

    monkeypatch.setattr(ns_vortex, "write_ns_tfrecord_dataset", write_small)
    ns_vortex.main(["synth", ds])
    assert calls == [ns_vortex.SYNTH]
    assert ns_vortex.SYNTH == dict(num_nodes=1900, tl=600, n_train=32, n_valid=2, n_test=4)
    assert ns_vortex.HYPERS["compute_dtype"] == "bfloat16"
    _, out = _train_and_eval(ns_vortex, ds, tmp_path)
    import h5py
    with h5py.File(os.path.join(out, "euler", "trajectories.h5"), "r") as f:
        assert np.isfinite(np.asarray(f["0"]["prediction"])).all()


MODULES = ["mgn_tpu_torch.ops.native", "mgn_tpu_torch.data.ns", "mgn_tpu_torch.data.convert",
           "mgn_tpu_torch.data.synthetic", "mgn_tpu_torch.rollout.evaluate",
           "mgn_tpu_torch.api", "mgn_tpu_torch.api_cloth", "mgn_tpu_torch.__main__",
           "mgn_tpu_torch.examples.airfoil", "mgn_tpu_torch.examples.deforming_plate",
           "mgn_tpu_torch.examples.flag_simple", "mgn_tpu_torch.examples.ns_vortex",
           "mgn_tpu_torch.examples.cylinder_flow"]


def test_new_modules_import_with_jax_mgn_tpu_and_h5py_blocked():
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'mgn_tpu', 'h5py'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from mgn_tpu_torch.ops import native\n"
            "print(native.route())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() in ("native", "numpy")
