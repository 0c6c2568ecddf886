"""Dataset conversion and inspection: the port's copy of
``mgn_tpu/data/convert.py``.

    python -m mgn_tpu_torch.data.convert to-tfrecord <src_dir> <dst_dir>
    python -m mgn_tpu_torch.data.convert to-h5 <src_dir> <dst_dir>
    python -m mgn_tpu_torch.data.convert inspect <dir>
    python -m mgn_tpu_torch.data.convert stats <dir>   # write der_minmax into meta

Works with any meta.json-described dataset that
:func:`mgn_tpu_torch.data.pipeline.load_dataset` reads.  ``to-tfrecord``,
``inspect`` and ``stats`` need no ``h5py`` (on TFRecord sources); ``to-h5``
writes HDF5 and so needs ``h5py``, imported at the call: where it is not
installed, ``to-h5`` raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from mgn_tpu_torch.data.hdf5 import import_h5py
from mgn_tpu_torch.data.meta import load_meta
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.tfrecord_writer import write_tfrecord_dataset

__all__ = ["to_h5", "to_tfrecord", "inspect", "stats", "main"]


def to_h5(src: str, dst: str) -> None:
    """Write ``src``'s splits as ``<dst>/{train,valid,test}.h5`` (one group
    per trajectory: mesh_pos, node_type, cells where given, each dynamic
    field) and its meta.json.  Needs ``h5py``."""
    h5py = import_h5py("convert to-h5")
    os.makedirs(dst, exist_ok=True)
    meta = load_meta(src)
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    for split, is_training in (("train", True), ("test", False)):
        try:
            ds = load_dataset(src, is_training=is_training, cache=False)
        except FileNotFoundError:
            continue
        jobs = [(f"{split}.h5", ds.num_trajectories, False)]
        if is_training and ds.num_valid:
            jobs.append(("valid.h5", ds.num_valid, True))
        for fname, count, valid in jobs:
            path = os.path.join(dst, fname)
            with h5py.File(path, "w") as f:
                for i in range(count):
                    t = ds.trajectory(i, valid=valid)
                    g = f.create_group(str(i))
                    g["mesh_pos"] = t.mesh_pos
                    g["node_type"] = t.node_type[:, None]
                    if t.cells is not None:
                        g["cells"] = t.cells
                    for name, arr in t.fields.items():
                        g[name] = arr
            print(f"wrote {path} ({count} trajectories)")


def to_tfrecord(src: str, dst: str) -> None:
    """Export any readable dataset to DeepMind-schema TFRecord files (a
    string ``dt``, per-trajectory times, becomes their median step)."""
    meta = dict(load_meta(src))
    tl = int(meta["trajectory_length"])
    splits = {}
    feat_meta = meta["features"]
    for split, is_training in (("train", True), ("test", False)):
        try:
            ds = load_dataset(src, is_training=is_training, cache=False)
        except FileNotFoundError:
            continue
        jobs = [(split, [ds.trajectory(i) for i in range(ds.num_trajectories)])]
        if is_training and ds.num_valid:
            jobs.append(("valid", [ds.trajectory(i, valid=True) for i in range(ds.num_valid)]))
        for name, trajs in jobs:
            out = []
            for tr in trajs:
                if isinstance(meta["dt"], str):
                    # the TFRecord schema has no per-trajectory time vectors
                    meta["dt"] = float(np.median(np.diff(tr.times)))
                feats = {"mesh_pos": tr.mesh_pos[None],
                         "node_type": tr.node_type[None, :, None]}
                if tr.cells is not None:
                    feats["cells"] = tr.cells[None]
                for f, arr in tr.fields.items():
                    feats[f] = arr
                out.append(feats)
            splits[name] = out
    # rewrite feature shapes to the TFRecord schema convention
    for f, fm in feat_meta.items():
        dim = int(fm.get("dim", 1))
        fm["shape"] = [1, -1, dim] if fm.get("type", "static") == "static" else [tl, -1, dim]
        fm.pop("key", None)
        fm.pop("split", None)
    write_tfrecord_dataset(dst, meta, splits)
    print(f"wrote TFRecord dataset to {dst} ({ {k: len(v) for k, v in splits.items()} })")


def inspect(path: str) -> None:
    """One JSON line per split (train, test): trajectory counts, and the
    first trajectory's node and step counts and array shapes."""
    for is_training, label in ((True, "train"), (False, "test")):
        try:
            ds = load_dataset(path, is_training=is_training, cache=False)
        except FileNotFoundError:
            continue
        t = ds.trajectory(0)
        print(json.dumps({
            "split": label,
            "trajectories": ds.num_trajectories,
            "valid_trajectories": ds.num_valid,
            "nodes": t.num_nodes,
            "steps": t.num_steps,
            "cells": None if t.cells is None else list(t.cells.shape),
            "edges": None if t.edges is None else list(t.edges.shape),
            "fields": {k: list(v.shape) for k, v in t.fields.items()},
        }))


def stats(path: str) -> None:
    """Compute output_min/output_max by der_minmax and merge them into
    meta.json."""
    from mgn_tpu_torch.utils.stats import der_minmax

    meta = load_meta(path)
    dm = der_minmax(path)
    for feature, rec in dm.items():
        meta["features"][feature].update(rec)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(dm))


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit(__doc__)
    cmd = argv[0]
    if cmd == "to-h5":
        to_h5(argv[1], argv[2])
    elif cmd == "to-tfrecord":
        to_tfrecord(argv[1], argv[2])
    elif cmd == "inspect":
        inspect(argv[1])
    elif cmd == "stats":
        stats(argv[1])
    else:
        raise SystemExit(f"unknown command {cmd!r}\n{__doc__}")


if __name__ == "__main__":
    main()
