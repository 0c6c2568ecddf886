"""Offline dataset statistics: the port's ``mgn_tpu/utils/stats.py``.

``der_minmax`` and ``data_meanstd`` give the ``output_min``/``output_max``
and ``data_mean``/``data_std`` values a meta.json holds, streaming over the
train, valid and test splits one trajectory at a time (numpy, on the host,
through :func:`mgn_tpu_torch.data.pipeline.load_dataset`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.train.common import FieldSpec

__all__ = ["der_minmax", "data_meanstd"]


def _iter_all(path: str):
    for is_training in (True, False):
        try:
            ds = load_dataset(path, is_training=is_training, cache=False)
        except FileNotFoundError:
            continue
        for i in range(ds.num_trajectories):
            yield ds, ds.trajectory(i)
        for i in range(ds.num_valid):
            yield ds, ds.trajectory(i, valid=True)


def der_minmax(path: str) -> Dict[str, Dict[str, float]]:
    """Min/max of the finite-difference derivative per target feature across
    train+valid+test.

    Returns {feature: {"output_min": .., "output_max": ..}} ready to merge into
    meta.json.
    """
    out: Dict[str, Dict[str, float]] = {}
    for ds, traj in _iter_all(path):
        spec = FieldSpec.from_meta(ds.meta)
        dts = np.diff(traj.times)
        for f in spec.target_fields:
            arr = traj.fields[f]
            der = (arr[1:] - arr[:-1]) / dts[:, None, None]
            rec = out.setdefault(f, {"output_min": np.inf, "output_max": -np.inf})
            rec["output_min"] = float(min(rec["output_min"], der.min()))
            rec["output_max"] = float(max(rec["output_max"], der.max()))
    return out


def data_meanstd(path: str) -> Dict[str, Dict[str, float]]:
    """Streaming mean/std per dynamic feature and per ``target|`` derivative.

    Returns {feature: {"data_mean", "data_std"}, "target|feature": {...}}.
    """
    acc: Dict[str, Dict[str, float]] = {}

    def update(key: str, arr: np.ndarray):
        a = acc.setdefault(key, {"n": 0.0, "s": 0.0, "ss": 0.0})
        flat = arr.reshape(-1).astype(np.float64)
        a["n"] += flat.size
        a["s"] += flat.sum()
        a["ss"] += np.square(flat).sum()

    for ds, traj in _iter_all(path):
        spec = FieldSpec.from_meta(ds.meta)
        dts = np.diff(traj.times)
        for f in spec.fields:
            update(f, traj.fields[f])
            if f in spec.target_fields:
                der = (traj.fields[f][1:] - traj.fields[f][:-1]) / dts[:, None, None]
                update("target|" + f, der)

    out: Dict[str, Dict[str, float]] = {}
    for k, a in acc.items():
        mean = a["s"] / max(a["n"], 1.0)
        var = max(a["ss"] / max(a["n"], 1.0) - mean * mean, 0.0)
        out[k] = {"data_mean": float(mean), "data_std": float(np.sqrt(var))}
    return out
