"""Dataset orchestration: the port's ``mgn_tpu/data/pipeline.py`` —
the canonical in-memory :class:`Trajectory`, the TFRecord reader,
:class:`Dataset` (lazy reads, caching, shape probes) and :func:`load_dataset`.

HDF5/JLD2 splits are found as in the JAX package but not read yet: their
reader needs ``h5py`` (imported only there, never at module level, since the
GPU machine lacks it) and comes with the next slice (ROADMAP A2).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np

from mgn_tpu_torch.data import tfrecord as tfr
from mgn_tpu_torch.data.meta import load_meta

__all__ = ["Trajectory", "TrajectoryStructure", "Dataset", "load_dataset"]


@dataclasses.dataclass
class Trajectory:
    """Canonical in-memory trajectory (host, row-major, node-major)."""

    mesh_pos: np.ndarray  # (N, D) f32
    node_type: np.ndarray  # (N,) i32
    times: np.ndarray  # (T,) f32 timestamps
    fields: Dict[str, np.ndarray]  # dynamic node fields, each (T, N, dim) f32
    cells: Optional[np.ndarray] = None  # (C, K) i32
    edges: Optional[np.ndarray] = None  # (E, 2) i32
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return self.mesh_pos.shape[0]

    @property
    def num_steps(self) -> int:
        return self.times.shape[0]


def _canonicalize(raw: Dict[str, np.ndarray], meta: Dict[str, Any]) -> Trajectory:
    """Reader output {feature: (T, N, dim)} -> Trajectory."""
    mesh_pos = np.asarray(raw["mesh_pos"], np.float32)
    if mesh_pos.ndim == 3:
        mesh_pos = mesh_pos[0]
    node_type = np.asarray(raw["node_type"], np.int32)
    if node_type.ndim == 3:
        node_type = node_type[0, :, 0]
    elif node_type.ndim == 2:
        node_type = node_type[:, 0]
    fields = {}
    extras = {}
    for fn in meta["feature_names"]:
        if fn in ("mesh_pos", "node_type", "cells"):
            continue
        arr = np.asarray(raw[fn], np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        fields[fn] = arr
        if fn + ".ev" in raw:
            extras[fn + ".ev"] = np.asarray(raw[fn + ".ev"], np.float32)
    cells = raw.get("cells")
    if cells is not None:
        cells = np.asarray(cells, np.int32)
        if cells.ndim == 3:
            cells = cells[0]
    edges = raw.get("edges")
    if edges is not None:
        edges = np.asarray(edges, np.int32).reshape(-1, 2)
    times = np.asarray(raw.get("times"), np.float32)
    return Trajectory(mesh_pos=mesh_pos, node_type=node_type, times=times,
                      fields=fields, cells=cells, edges=edges, extras=extras)


@dataclasses.dataclass
class TrajectoryStructure:
    """Shape-only view of a trajectory (bucket sizing without field I/O).
    Duck-typed against :class:`Trajectory` for ``common_buckets``."""

    num_nodes: int
    cells: Optional[np.ndarray] = None
    edges: Optional[np.ndarray] = None


class _TFRecordReader:
    def __init__(self, path: str, meta: Dict[str, Any]):
        self.path = path
        self.meta = meta
        with open(path, "rb") as f:
            data = f.read()
        # index record boundaries once; payloads decoded on demand
        self._offsets: List[tuple[int, int]] = []
        pos = 0
        while pos + 12 <= len(data):
            (ln,) = struct.unpack_from("<Q", data, pos)
            self._offsets.append((pos + 12, ln))
            pos += 12 + ln + 4
        self._data = data

    def __len__(self) -> int:
        return len(self._offsets)

    def read(self, i: int) -> Trajectory:
        off, ln = self._offsets[i]
        raw = dict(tfr.parse_trajectory(tfr.parse_example(self._data[off: off + ln]),
                                        self.meta))
        tl = int(self.meta["trajectory_length"])
        raw["times"] = np.arange(tl, dtype=np.float32) * np.float32(self.meta["dt"])
        return _canonicalize(raw, self.meta)

    def read_structure(self, i: int) -> Optional[TrajectoryStructure]:
        """Cheap shape probe; None means 'needs a full read'."""
        off, ln = self._offsets[i]
        example = tfr.parse_example(self._data[off: off + ln], keys={"mesh_pos", "cells"})
        raw = tfr.parse_trajectory(example, self.meta)
        if "mesh_pos" not in raw or "cells" not in raw:
            return None
        mp = raw["mesh_pos"]
        cells = np.asarray(raw["cells"], np.int32)
        if cells.ndim == 3:
            cells = cells[0]
        return TrajectoryStructure(num_nodes=int(mp.shape[1] if mp.ndim == 3 else mp.shape[0]),
                                   cells=cells)


class Dataset:
    """Train/valid (or test) split pair with caching and shape probes."""

    def __init__(self, meta: Dict[str, Any], reader: _TFRecordReader,
                 reader_valid: Optional[_TFRecordReader] = None, cache: bool = True):
        self.meta = meta
        self._reader = reader
        self._reader_valid = reader_valid
        self._cache: Dict[tuple, Trajectory] = {}
        self._structures: Dict[tuple, TrajectoryStructure] = {}
        self._use_cache = cache
        self.num_trajectories = len(reader)
        self.num_valid = len(reader_valid) if reader_valid is not None else 0

    def trajectory(self, i: int, valid: bool = False) -> Trajectory:
        key = ("v" if valid else "t", i % (self.num_valid if valid else self.num_trajectories))
        if key in self._cache:
            return self._cache[key]
        reader = self._reader_valid if valid else self._reader
        traj = reader.read(key[1])
        if self._use_cache:
            self._cache[key] = traj
        return traj

    def structure(self, i: int, valid: bool = False) -> TrajectoryStructure:
        """Shape-only trajectory view (num_nodes + connectivity) — cheap
        enough to scan over every trajectory for bucket sizing."""
        n = self.num_valid if valid else self.num_trajectories
        key = ("sv" if valid else "st", i % n)
        if key in self._structures:
            return self._structures[key]
        reader = self._reader_valid if valid else self._reader
        st = reader.read_structure(key[1])
        if st is None:  # layout defeats the cheap probe: full read
            t = self.trajectory(i, valid=valid)
            st = TrajectoryStructure(num_nodes=t.num_nodes, cells=t.cells, edges=t.edges)
        self._structures[key] = st
        return st


def load_dataset(path: str, is_training: bool = True, cache: bool = True) -> Dataset:
    """Discover and open a dataset directory.

    Per split the JAX package's priority: ``<split>.tfrecord``, then
    ``<split>.h5``, then ``<split>.jld2``.  ``is_training`` selects
    train+valid against test.  An HDF5/JLD2 split raises
    ``NotImplementedError``: the port has no HDF5 reader yet.
    """
    meta = load_meta(path)
    split = "train" if is_training else "test"

    def open_reader(name: str) -> Optional[_TFRecordReader]:
        for ext in (".tfrecord", ".h5", ".jld2"):
            p = os.path.join(path, name + ext)
            if not os.path.isfile(p):
                continue
            if ext != ".tfrecord":
                raise NotImplementedError(
                    f"{p}: the HDF5/JLD2 reader is not ported yet (ROADMAP.md, A2); "
                    "convert the dataset to TFRecord (python -m mgn_tpu.data.convert "
                    "to-tfrecord) or use a .tfrecord split")
            return _TFRecordReader(p, meta)
        return None

    reader = open_reader(split)
    if reader is None:
        raise FileNotFoundError(f"no {split}.tfrecord/.h5 in {path}")
    reader_valid = open_reader("valid") if is_training else None
    meta = dict(meta)
    meta["n_trajectories"] = len(reader)
    if reader_valid is not None:
        meta["n_trajectories_valid"] = len(reader_valid)
    return Dataset(meta, reader, reader_valid, cache=cache)
