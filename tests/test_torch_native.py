"""Port: the native graph builder (``mgn_tpu_torch/ops/native.py``, a ctypes
load of ``native/graph_builder.cpp``) and ``build_template``'s native route
against its numpy route and against the JAX package: the same edge set per
receiver row, sorted by (receiver, sender), and the JAX package's template
bit for bit where both libraries load.  The library is built with g++ into
``mgn_tpu_torch/ops/build/`` and nothing is written under ``native/``."""

import os
import subprocess

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from mgn_tpu.core import graph as JG
from mgn_tpu.ops import native as jax_native
from mgn_tpu_torch.core import graph as TG
from mgn_tpu_torch.data.synthetic import make_channel_mesh, plate_grid
from mgn_tpu_torch.ops import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(senders, receivers, n):
    """Each receiver's set of senders."""
    rows = [set() for _ in range(n)]
    for s, r in zip(senders.tolist(), receivers.tolist()):
        rows[r].add(s)
    return rows


def _cases():
    rng = np.random.default_rng(4)
    pos, cells, _ = make_channel_mesh(200, seed=2)
    return {
        "triangles": (cells, len(pos)),
        "quads_with_repeats": (rng.integers(0, 50, size=(80, 4)).astype(np.int32), 50),
        "grid_pairs_and_a_loop": (np.concatenate([plate_grid((4, 3, 3)), [[5, 5]]]), 36),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_native_route_is_the_numpy_route_sorted_by_receiver_then_sender(name):
    cells, n = _cases()[name]
    assert native.available() and native.route() == "native"
    s, r = native.cells_to_edges_native(cells)
    s_np, r_np = TG.cells_to_edges(cells)
    assert len(s) == len(s_np) and s.dtype == r.dtype == np.int32
    assert _rows(s, r, n) == _rows(s_np, r_np, n)
    order = np.lexsort((s, r))
    np.testing.assert_array_equal(order, np.arange(len(s)))
    np.testing.assert_array_equal(native.csr_offsets_native(r, n), TG.csr_row_offsets(r, n))
    pos = np.random.default_rng(0).random((n, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.edge_features_native(pos, s, r),
                                  TG.relative_mesh_features(pos, s, r))


def _templates():
    pos, cells, nt = make_channel_mesh(150, seed=1)
    rng = np.random.default_rng(1)
    pos60 = rng.random((60, 2)).astype(np.float32)
    grid = np.stack(np.meshgrid(*[np.linspace(0, 1, d) for d in (4, 3, 3)], indexing="ij"),
                    -1).reshape(-1, 3, order="F").astype(np.float32)
    return {
        "cells": (pos, nt, dict(cells=cells)),
        "edges_one_based": (pos60, rng.integers(0, 7, 60).astype(np.int32),
                            dict(edges=np.stack([np.arange(1, 60), np.arange(2, 61)], 1))),
        "edges_two_by_e": (pos60, np.zeros(60, np.int32),
                           dict(edges=np.stack([np.arange(0, 59), np.arange(1, 60)]))),
        "grid_as_cells": (grid, np.zeros(36, np.int32), dict(cells=plate_grid((4, 3, 3)))),
    }


@pytest.mark.parametrize("name", list(_templates()))
def test_build_template_is_the_jax_packages_bit_for_bit(name):
    pos, nt, kw = _templates()[name]
    assert native.available()
    if not jax_native.available():  # the JAX package's numpy route: rows as sets
        pytest.fail("the JAX package's native library did not load")
    out, ref = TG.build_template(pos, nt, **kw), JG.build_template(pos, nt, **kw)
    for field in ("senders", "receivers", "row_offsets", "mesh_edge_features", "node_mask",
                  "edge_mask", "node_type", "node_type_onehot"):
        np.testing.assert_array_equal(getattr(out, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)


def test_without_the_library_build_template_takes_the_numpy_route(monkeypatch):
    """The numpy route: cells_to_edges, then a sort by (receiver, sender).  It
    gives the native route's template bit for bit, also in a row holding a
    self-loop (an excluded grid node's placeholder), which cells_to_edges puts
    last and the sort puts in sender order."""
    cells = np.concatenate([plate_grid((4, 3, 3)), [[5, 5]]])
    pos = np.random.default_rng(3).random((36, 3)).astype(np.float32)
    nt = np.zeros(36, np.int32)
    native_t = TG.build_template(pos, nt, cells=cells)
    monkeypatch.setattr(native, "available", lambda: False)
    assert native.route() == "numpy"
    t = TG.build_template(pos, nt, cells=cells)
    s, r = TG.cells_to_edges(cells)
    assert s[-1] == r[-1] == 5  # the self-loop comes last out of cells_to_edges
    for field in ("senders", "receivers", "row_offsets", "mesh_edge_features", "sender_perm",
                  "sender_offsets", "node_mask", "edge_mask", "node_type", "node_type_onehot"):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      getattr(native_t, field).numpy(), err_msg=field)
    e = int(t.edge_mask.sum())
    np.testing.assert_array_equal(np.lexsort((t.senders.numpy()[:e], t.receivers.numpy()[:e])),
                                  np.arange(e))


def test_the_build_writes_only_under_the_ports_build_directory(tmp_path, monkeypatch):
    """A fresh build: one g++ call without -march, its output in the build
    directory (by default mgn_tpu_torch/ops/build/), native/'s sources as
    they were and none of the port's build outputs there."""
    assert native._BUILD == os.path.join(ROOT, "mgn_tpu_torch", "ops", "build")
    tracked = ("graph_builder.cpp", "build.sh")  # the JAX package's build may add its own .so
    before = {f: os.stat(os.path.join(ROOT, "native", f)).st_mtime_ns for f in tracked}
    calls = []
    run = subprocess.run

    def recording_run(cmd, **kw):
        calls.append(cmd)
        return run(cmd, **kw)

    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native.subprocess, "run", recording_run)
    assert native.load_library() is not None
    assert len(calls) == 1 and calls[0][0] == "g++"
    assert not any(a.startswith("-march") for a in calls[0])
    out = calls[0][calls[0].index("-o") + 1]
    assert os.path.dirname(out) == str(tmp_path / "build")
    assert os.listdir(tmp_path / "build") == [os.path.basename(native._so_path())]
    after = {f: os.stat(os.path.join(ROOT, "native", f)).st_mtime_ns for f in tracked}
    assert after == before
    outputs = os.listdir(os.path.join(ROOT, "native"))
    assert not any(f.startswith("libmgn_native-") for f in outputs)  # the port's .so name
    s, r = native.cells_to_edges_native(np.array([[0, 1, 2]], np.int32))
    np.testing.assert_array_equal(r, [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(s, [1, 2, 0, 2, 0, 1])
