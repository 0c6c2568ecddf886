"""meta.json dataset-schema contract: the port's copy of the parts of
``mgn_tpu/data/meta.py`` that serving needs.

Keys ``dt``, ``trajectory_length``, ``dims``, ``feature_names``,
``features`` are required; per-feature ``type/dtype/dim/onehot/data_min/
data_max/...`` as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

__all__ = ["load_meta", "validate_meta", "node_type_range", "spatial_dim"]

_DTYPES = ("float32", "float64", "int32", "int64", "bool")


def load_meta(path: str) -> Dict[str, Any]:
    """Load and validate ``meta.json`` from a dataset directory (or file path)."""
    if os.path.isdir(path):
        path = os.path.join(path, "meta.json")
    with open(path) as f:
        meta = json.load(f)
    validate_meta(meta)
    return meta


def validate_meta(meta: Dict[str, Any]) -> None:
    for key in ("dt", "trajectory_length", "dims", "feature_names", "features"):
        if key not in meta:
            raise KeyError(f"meta.json missing required key {key!r}")
    for fn in meta["feature_names"]:
        if fn not in meta["features"]:
            raise KeyError(f"feature {fn!r} listed but not described in 'features'")
        f = meta["features"][fn]
        if f.get("type", "static") not in ("static", "dynamic"):
            raise ValueError(f"feature {fn!r}: type must be static|dynamic")
        if f.get("dtype", "float32") not in _DTYPES:
            raise ValueError(f"feature {fn!r}: unsupported dtype {f.get('dtype')!r}")
    for tf in meta.get("target_features", []):
        if tf not in meta["features"]:
            raise KeyError(f"target feature {tf!r} not described in 'features'")


def node_type_range(meta: Dict[str, Any]) -> tuple[int, int]:
    """(data_min, data_max) of the node_type one-hot feature."""
    f = meta["features"]["node_type"]
    return int(f.get("data_min", 0)), int(f.get("data_max", 6))


def spatial_dim(meta: Dict[str, Any]) -> int:
    dims = meta["dims"]
    return len(dims) if isinstance(dims, (list, tuple)) else int(dims)
