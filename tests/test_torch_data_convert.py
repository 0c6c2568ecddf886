"""Port: dataset conversion and inspection (``mgn_tpu_torch/data/convert.py``)
against ``mgn_tpu/data/convert.py`` on the CPU: ``inspect`` prints the JAX
package's JSON lines, ``stats`` writes its ``der_minmax`` into meta.json,
``to-tfrecord`` writes the JAX package's files, which read back equal to
the source, ``to-h5`` writes what the JAX package's does where ``h5py`` is
installed and raises naming ``h5py`` where it is not, and ``python -m
mgn_tpu_torch.data.convert`` runs ``main``."""

import json
import os
import shutil
import subprocess
import sys

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from mgn_tpu.data import convert as JC
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.synthetic import write_airfoil_dataset, write_plate_dataset
from mgn_tpu_torch.data import convert as TC
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.synthetic import (write_plate_tfrecord_dataset,
                                          write_synthetic_tfrecord_dataset)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = dict(n_train=2, n_valid=1, n_test=1)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Datasets of three layouts: a channel-flow TFRecord, a plate TFRecord
    (grid pairs as cells) and the JAX package's HDF5 airfoil and plate (the
    plate's edges synthesised from the grid)."""
    root = tmp_path_factory.mktemp("convert")
    out = {k: str(root / k) for k in ("cylinder", "plate", "airfoil_h5", "plate_h5")}
    write_synthetic_tfrecord_dataset(out["cylinder"], num_nodes=60, tl=5, **COUNTS)
    write_plate_tfrecord_dataset(out["plate"], tl=5, **COUNTS)
    write_airfoil_dataset(out["airfoil_h5"], num_nodes=48, tl=5, **COUNTS)
    write_plate_dataset(out["plate_h5"], tl=5, **COUNTS)
    return out


@pytest.mark.parametrize("name", ["cylinder", "plate", "airfoil_h5", "plate_h5"])
def test_inspect_prints_the_jax_lines(sources, name, capsys):
    TC.inspect(sources[name])
    got = capsys.readouterr().out
    JC.inspect(sources[name])
    ref = capsys.readouterr().out
    assert got == ref and [json.loads(x)["split"] for x in got.splitlines()] == ["train", "test"]


def test_stats_writes_the_jax_der_minmax(sources, tmp_path, capsys):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    for d in (port, ref):
        shutil.copytree(sources["airfoil_h5"], d)
    TC.stats(port)
    JC.stats(ref)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1]
    with open(os.path.join(port, "meta.json")) as a, open(os.path.join(ref, "meta.json")) as b:
        got, want = json.load(a), json.load(b)
    assert got == want
    assert {"output_min", "output_max"} <= set(got["features"]["density"])


def _same_dataset(a_dir, b_dir, loader_a=load_dataset, loader_b=load_dataset):
    for is_training in (True, False):
        a, b = loader_a(a_dir, is_training), loader_b(b_dir, is_training)
        assert (a.num_trajectories, a.num_valid) == (b.num_trajectories, b.num_valid)
        jobs = [(i, False) for i in range(a.num_trajectories)]
        jobs += [(i, True) for i in range(a.num_valid)]
        for i, valid in jobs:
            x, y = a.trajectory(i, valid=valid), b.trajectory(i, valid=valid)
            assert sorted(x.fields) == sorted(y.fields)
            for f in x.fields:
                np.testing.assert_array_equal(x.fields[f], y.fields[f], err_msg=f)
            for name in ("mesh_pos", "node_type", "times", "cells"):
                np.testing.assert_array_equal(getattr(x, name), getattr(y, name), err_msg=name)


@pytest.mark.parametrize("name", ["airfoil_h5", "plate"])
def test_to_tfrecord_writes_the_jax_files_which_read_back_equal(sources, name, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    TC.to_tfrecord(sources[name], port)
    JC.to_tfrecord(sources[name], ref)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for f in os.listdir(ref):
        with open(os.path.join(port, f), "rb") as a, open(os.path.join(ref, f), "rb") as b:
            assert a.read() == b.read(), f
    _same_dataset(port, sources[name])


def test_to_h5_writes_what_the_jax_package_writes(sources, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    TC.to_h5(sources["plate"], port)
    JC.to_h5(sources["plate"], ref)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    _same_dataset(port, ref, jax_load_dataset, jax_load_dataset)


def test_to_h5_without_h5py_raises_naming_it(sources, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    dst = str(tmp_path / "dst")
    with pytest.raises(ImportError, match="to-h5 needs h5py"):
        TC.to_h5(sources["cylinder"], dst)
    assert not os.path.exists(dst)
    with pytest.raises(SystemExit, match="unknown command"):
        TC.main(["to-hdf5", sources["cylinder"], dst])


def test_python_m_runs_main(sources, capsys):
    r = subprocess.run([sys.executable, "-m", "mgn_tpu_torch.data.convert", "inspect",
                        sources["plate"]], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    JC.inspect(sources["plate"])
    assert r.stdout == capsys.readouterr().out
