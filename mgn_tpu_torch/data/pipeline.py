"""The canonical in-memory trajectory (``mgn_tpu/data/pipeline.py``'s
``Trajectory``).  The dataset readers come with the training slice."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["Trajectory"]


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
