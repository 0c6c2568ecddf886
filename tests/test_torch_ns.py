"""Port: the Navier-Stokes vortex-shedding generator (``mgn_tpu_torch/data/ns.py``)
against ``mgn_tpu/data/ns.py`` on the CPU: the projection solver, the
cylinder-hole mesh and the grid-to-mesh interpolation bit for bit, the
TFRecord dataset read back equal to the JAX package's HDF5 dataset for the
same arguments, and the writer's idempotency (meta.json written last, its
presence returns at once)."""

import json
import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from mgn_tpu.data import ns as JNS
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu_torch.data import ns as TNS
from mgn_tpu_torch.data.pipeline import load_dataset

# a small run: a 64 x 32 grid, 0.1 time units of spin-up, a few frames
SOLVE = dict(nx=64, ny=32, u_peak=1.1, frames=5, frame_dt=0.01, spin_up=0.1, seed=3)
WRITE = dict(num_nodes=150, tl=4, n_train=2, n_valid=1, n_test=1, nx=32, ny=16, spin_up=0.05,
             seed=2, verbose=False)


def test_solver_is_the_jax_packages_bit_for_bit():
    U, V, (xs, ys) = TNS.solve_ns_channel(**SOLVE)
    Uj, Vj, (xsj, ysj) = JNS.solve_ns_channel(**SOLVE)
    assert U.shape == (5, 64, 32) and U.dtype == np.float32 and np.isfinite(U).all()
    for a, b in ((U, Uj), (V, Vj), (xs, xsj), (ys, ysj)):
        np.testing.assert_array_equal(a, b)
    assert np.abs(V).max() > 0  # the seed perturbation moved the wake


@pytest.mark.parametrize("num_nodes,seed", [(300, 1), (1900, 0)])
def test_cylinder_mesh_and_interpolation_are_the_jax_packages(num_nodes, seed):
    mesh, ref = TNS.make_cylinder_mesh(num_nodes, seed), JNS.make_cylinder_mesh(num_nodes, seed)
    for a, b in zip(mesh, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    U, V = (rng.standard_normal((3, 40, 20)).astype(np.float32) for _ in range(2))
    xs, ys = (np.arange(40) + 0.5) * 0.05, (np.arange(20) + 0.5) * 0.05
    np.testing.assert_array_equal(TNS.interp_grid_to_mesh(U, V, xs, ys, mesh[0]),
                                  JNS.interp_grid_to_mesh(U, V, xs, ys, ref[0]))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ns")
    port, jax_ds = str(root / "port"), str(root / "jax")
    meta = TNS.write_ns_tfrecord_dataset(port, **WRITE)
    JNS.write_ns_dataset(jax_ds, **WRITE)
    return port, jax_ds, meta


def test_dataset_reads_back_as_the_jax_packages(datasets):
    port, jax_ds, meta = datasets
    assert sorted(os.listdir(port)) == ["meta.json", "test.tfrecord", "train.tfrecord",
                                        "valid.tfrecord"]
    with open(os.path.join(jax_ds, "meta.json")) as f:
        assert meta == json.load(f)
    for is_training, splits in ((True, ((0, False), (1, False), (0, True))),
                                (False, ((0, False),))):
        a, b = load_dataset(port, is_training), jax_load_dataset(jax_ds, is_training)
        for i, valid in splits:
            x, y = a.trajectory(i, valid=valid), b.trajectory(i, valid=valid)
            for name in ("mesh_pos", "node_type", "cells", "times"):
                np.testing.assert_array_equal(getattr(x, name), getattr(y, name))
            np.testing.assert_array_equal(x.fields["velocity"], y.fields["velocity"])
            assert np.isfinite(x.fields["velocity"]).all()


def test_writer_is_idempotent(datasets, tmp_path):
    """meta.json marks a finished dataset: a second call returns it and
    writes nothing; without it the writer writes every split again."""
    port, _, meta = datasets
    stamps = {f: os.stat(os.path.join(port, f)).st_mtime_ns for f in os.listdir(port)}
    assert TNS.write_ns_tfrecord_dataset(port, **WRITE) == meta
    assert {f: os.stat(os.path.join(port, f)).st_mtime_ns for f in os.listdir(port)} == stamps
    partial = str(tmp_path / "partial")
    os.makedirs(partial)
    with open(os.path.join(partial, "train.tfrecord.tmp"), "wb") as f:
        f.write(b"interrupted")
    small = dict(WRITE, n_train=1, n_valid=0, n_test=0)
    TNS.write_ns_tfrecord_dataset(partial, **small)
    assert sorted(os.listdir(partial)) == ["meta.json", "test.tfrecord", "train.tfrecord",
                                           "valid.tfrecord"]
    np.testing.assert_array_equal(load_dataset(partial).trajectory(0).fields["velocity"],
                                  load_dataset(port).trajectory(0).fields["velocity"])
