"""Port: the HDF5/JLD2 reader (``data/hdf5``, ``load_dataset``'s ``.h5`` and
``.jld2`` splits), ``core/graph.grid_edges`` and ``utils/stats`` against the
JAX package on the CPU.  The layouts are those of ``test_hdf5_features.py``
(``%d``-indexed and split keys, ``.ev`` extras, a timestamp vector, custom
edges with exclusions, grid edges, JLD2), rebuilt here."""

import json
import os
import sys

import h5py
import numpy as np
import pytest

from mgn_tpu.core.graph import grid_edges as jax_grid_edges
from mgn_tpu.data import hdf5 as JH
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.synthetic import write_synthetic_dataset
from mgn_tpu.utils import stats as jax_stats
import mgn_tpu_torch
from mgn_tpu_torch.core.graph import grid_edges
from mgn_tpu_torch.data import hdf5 as TH
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.train.common import FieldSpec


def _write(d, meta, groups, name="train.h5"):
    """``groups``: {group: {dataset: array}}; writes the file and meta.json."""
    with h5py.File(os.path.join(d, name), "w") as f:
        for g, items in groups.items():
            grp = f.create_group(g)
            for k, v in items.items():
                grp[k] = v
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    return os.path.join(d, name)


def _same_raw(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def grid_ds(tmp_path_factory):
    """A 1-D grid with %d-indexed, split and .ev features and a timestamp
    vector."""
    d = str(tmp_path_factory.mktemp("gridds"))
    tl, n = 6, 5
    meta = {
        "dt": "timestamps", "trajectory_length": tl, "dims": [5],
        "feature_names": ["mesh_pos", "node_type", "temp", "disp"],
        "target_features": ["temp"],
        "features": {
            "mesh_pos": {"type": "static", "dim": 1, "dtype": "float32", "key": "pos%d"},
            "node_type": {"type": "static", "dim": 1, "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 6, "key": "type%d"},
            "temp": {"type": "dynamic", "dim": 1, "dtype": "float32", "key": "T%d",
                     "has_ev": True},
            "disp": {"type": "dynamic", "dim": 2, "dtype": "float32", "key": "u%d",
                     "split": True},
        },
    }
    rng = np.random.default_rng(0)
    temps = rng.random((n, tl)).astype(np.float32)
    disps = rng.random((n, 2, tl)).astype(np.float32)
    g = {"timestamps": (np.arange(tl) * 0.5).astype(np.float32)}
    for i in range(n):
        g[f"pos{i}"] = np.float32(i * 0.25)
        g[f"type{i}"] = np.int32(0 if 0 < i < n - 1 else 6)
        g[f"T{i}"] = temps[i]
        g[f"T{i}.ev"] = np.stack([temps[i], temps[i]], 1)
        g[f"u{i}[0]"] = disps[i, 0]
        g[f"u{i}[1]"] = disps[i, 1]
    return d, meta, _write(d, meta, {"traj0": g}), temps, disps


def test_percent_d_split_keys_ev_and_times_match_jax(grid_ds):
    d, meta, path, temps, disps = grid_ds
    got = TH.read_trajectory(path, "traj0", meta)
    _same_raw(got, JH.read_trajectory(path, "traj0", meta))
    np.testing.assert_array_equal(got["temp"][:, :, 0], temps.T)
    np.testing.assert_array_equal(got["disp"][:, :, 1], disps[:, 1].T)
    assert got["temp.ev"].shape == (6, 5, 2)
    np.testing.assert_array_equal(got["times"], np.arange(6, dtype=np.float32) * 0.5)
    assert set(map(tuple, np.sort(got["edges"], axis=1))) == {(0, 1), (1, 2), (2, 3), (3, 4)}
    assert TH.read_structure(path, "traj0", meta)[0] == 5
    assert TH.trajectory_keys(path) == JH.trajectory_keys(path) == ["traj0"]


def test_extras_are_read_but_stripped_from_the_model_inputs(grid_ds):
    d, meta, *_ = grid_ds
    t, ref = load_dataset(d).trajectory(0), jax_load_dataset(d).trajectory(0)
    assert sorted(t.extras) == sorted(ref.extras) == ["temp.ev"]
    np.testing.assert_array_equal(t.extras["temp.ev"], ref.extras["temp.ev"])
    assert "temp.ev" not in t.fields
    assert all(not f.endswith(".ev") for f in FieldSpec.from_meta(meta).fields)


def test_grid_edges_with_excluded_types_match_jax(tmp_path):
    """A 2-D grid of 4 x 3 nodes with no %d keys; nodes of type 9 get no
    grid edge and a self-loop."""
    tl, dims = 3, [4, 3]
    n = 12
    meta = {
        "dt": 0.1, "trajectory_length": tl, "dims": dims, "no_edges_node_types": [9],
        "feature_names": ["mesh_pos", "node_type", "val"], "target_features": ["val"],
        "features": {
            "mesh_pos": {"type": "static", "dim": 2, "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 9},
            "val": {"type": "dynamic", "dim": 1, "dtype": "float32"},
        },
    }
    nt = np.zeros((n,), np.int32)
    nt[[4, 7]] = 9
    path = _write(str(tmp_path), meta, {"0": {
        "mesh_pos": np.random.default_rng(1).random((n, 2)).astype(np.float32),
        "node_type": nt, "val": np.ones((tl, n), np.float32)}})
    got = TH.read_trajectory(path, "0", meta)
    _same_raw(got, JH.read_trajectory(path, "0", meta))
    pairs = set(map(tuple, got["edges"]))
    assert (4, 4) in pairs and (7, 7) in pairs
    assert not any((4 in p or 7 in p) and p[0] != p[1] for p in pairs)
    for a, b in zip(TH.read_structure(path, "0", meta), JH.read_structure(path, "0", meta)):
        np.testing.assert_array_equal(a, b)
    t, ref = load_dataset(str(tmp_path)).trajectory(0), jax_load_dataset(
        str(tmp_path)).trajectory(0)
    np.testing.assert_array_equal(t.edges, ref.edges)


def test_custom_edges_with_exclusions_match_jax(tmp_path):
    tl, n = 3, 6
    meta = {
        "dt": 0.1, "trajectory_length": tl, "dims": [6], "custom_edges": "graph_edges",
        "no_edges_node_types": [9], "exclude_node_indices": [5],
        "feature_names": ["mesh_pos", "node_type", "val"], "target_features": ["val"],
        "features": {
            "mesh_pos": {"type": "static", "dim": 1, "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 9},
            "val": {"type": "dynamic", "dim": 1, "dtype": "float32"},
        },
    }
    path = _write(str(tmp_path), meta, {"0": {
        "mesh_pos": np.arange(n, dtype=np.float32)[:, None],
        "node_type": np.array([0, 0, 9, 0, 0, 0], np.int32)[:, None],
        "val": np.ones((tl, n), np.float32),
        "graph_edges": np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]], np.int32)}})
    got = TH.read_trajectory(path, "0", meta)
    _same_raw(got, JH.read_trajectory(path, "0", meta))
    assert set(map(tuple, got["edges"])) == {(0, 1), (3, 4)}


def test_jld2_layout_matches_jax(tmp_path):
    """A .jld2 split reads through the HDF5 reader, its ``_types`` group
    skipped; Julia's column-major arrays land on the row-major layout."""
    tl, n = 4, 7
    meta = {
        "dt": 0.1, "trajectory_length": tl, "dims": 1, "custom_edges": "edges_custom",
        "feature_names": ["mesh_pos", "node_type", "temp"], "target_features": ["temp"],
        "features": {
            "mesh_pos": {"type": "static", "dim": 1, "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 6},
            "temp": {"type": "dynamic", "dim": 1, "dtype": "float32"},
        },
    }
    temp = np.random.default_rng(3).random((tl, n)).astype(np.float32)
    group = {"mesh_pos": np.linspace(0, 1, n).astype(np.float32),
             "node_type": np.zeros((n,), np.int32), "temp": temp,
             "edges_custom": np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int32)}
    path = _write(str(tmp_path), meta, {"_types": {"00000001": np.int32(0)}, "0": group,
                                        "1": group}, name="train.jld2")
    assert TH.trajectory_keys(path) == JH.trajectory_keys(path) == ["0", "1"]
    ds, ref = load_dataset(str(tmp_path)), jax_load_dataset(str(tmp_path))
    assert ds.num_trajectories == ref.num_trajectories == 2
    t, r = ds.trajectory(1), ref.trajectory(1)
    np.testing.assert_array_equal(t.fields["temp"], r.fields["temp"])
    np.testing.assert_array_equal(t.fields["temp"][:, :, 0], temp)
    np.testing.assert_array_equal(t.edges, r.edges)
    np.testing.assert_array_equal(t.mesh_pos, r.mesh_pos)


def test_place_rejects_a_transposed_layout(tmp_path):
    tl, n = 5, 9
    meta = {
        "dt": 0.1, "trajectory_length": tl, "dims": 1,
        "feature_names": ["mesh_pos", "node_type", "temp"], "target_features": ["temp"],
        "features": {
            "mesh_pos": {"type": "static", "dim": 1, "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 6},
            "temp": {"type": "dynamic", "dim": 1, "dtype": "float32"},
        },
    }
    path = _write(str(tmp_path), meta, {"0": {
        "mesh_pos": np.zeros((n,), np.float32), "node_type": np.zeros((n,), np.int32),
        "temp": np.zeros((n, tl), np.float32)}})  # (N, T): transposed
    for reader in (TH, JH):
        with pytest.raises(ValueError, match="does not match the meta.json layout"):
            reader.read_trajectory(path, "0", meta)


@pytest.fixture(scope="module")
def synth_h5(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth_h5"))
    write_synthetic_dataset(d, num_nodes=48, tl=5, n_train=2, n_valid=1, n_test=1)
    return d


def test_load_dataset_h5_gives_the_jax_trajectories(synth_h5):
    for training in (True, False):
        ds, ref = load_dataset(synth_h5, training), jax_load_dataset(synth_h5, training)
        assert (ds.num_trajectories, ds.num_valid) == (ref.num_trajectories, ref.num_valid)
        assert ds.meta == ref.meta
        splits = [(i, False) for i in range(ds.num_trajectories)]
        splits += [(i, True) for i in range(ds.num_valid)]
        for i, valid in splits:
            t, r = ds.trajectory(i, valid=valid), ref.trajectory(i, valid=valid)
            for name in ("mesh_pos", "node_type", "times", "cells", "edges"):
                a, b = getattr(t, name), getattr(r, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_array_equal(a, b, err_msg=name)
            assert sorted(t.fields) == sorted(r.fields)
            for f in r.fields:
                np.testing.assert_array_equal(t.fields[f], r.fields[f])
            s, rs = ds.structure(i, valid=valid), ref.structure(i, valid=valid)
            assert s.num_nodes == rs.num_nodes
            np.testing.assert_array_equal(s.cells, rs.cells)


def test_h5_split_without_h5py_names_the_tfrecord_route(synth_h5, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py.*TFRecord"):
        load_dataset(synth_h5)


@pytest.mark.parametrize("stat", ["der_minmax", "data_meanstd"])
def test_stats_match_jax(synth_h5, stat):
    got = getattr(mgn_tpu_torch, stat)(synth_h5)
    ref = getattr(jax_stats, stat)(synth_h5)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert sorted(got[k]) == sorted(ref[k])
        for v in ref[k]:
            np.testing.assert_allclose(got[k][v], ref[k][v], rtol=1e-6, err_msg=f"{k}.{v}")


@pytest.mark.parametrize("dims", [[7], [4, 5], [3, 1, 4], [2, 3, 4]])
@pytest.mark.parametrize("excluded", [(), (2,)])
def test_grid_edges_match_jax(dims, excluded):
    n = int(np.prod(dims))
    nt = np.random.default_rng(n).integers(0, 4, n).astype(np.int32)
    got = grid_edges(dims, node_type=nt, no_edges_node_types=excluded)
    ref = jax_grid_edges(dims, node_type=nt, no_edges_node_types=excluded)
    for a, b in zip(got, ref, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
