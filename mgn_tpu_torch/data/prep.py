"""Host -> device trajectory preparation: the port's copy of
``mgn_tpu/data/prep.py`` (``prepare_trajectory`` and
``PreparedTrajectory.unpermute``).

Builds the static :class:`GraphTemplate` and pads every dynamic field to the
template's node bucket.  Spatial reordering is a TPU banding aid that the
GPU kernels do not need; it is not ported (``spatial_reorder=True`` raises).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from mgn_tpu_torch.core.graph import GraphTemplate, build_template
from mgn_tpu_torch.data.meta import node_type_range
from mgn_tpu_torch.data.pipeline import Trajectory
from mgn_tpu_torch.train.common import FieldSpec

__all__ = ["PreparedTrajectory", "prepare_trajectory"]


class PreparedTrajectory:
    """Device-ready trajectory: template + padded field stacks + times.
    Template rows keep the dataset's node order (no spatial reordering)."""

    def __init__(self, template: GraphTemplate, fields: Dict[str, torch.Tensor],
                 times: torch.Tensor, num_nodes: int, num_steps: int):
        self.template = template
        self.fields = fields  # each (T, N_pad, dim) float32
        self.times = times  # (T,)
        self.num_nodes = num_nodes
        self.num_steps = num_steps

    def unpermute(self, per_node: np.ndarray) -> np.ndarray:
        """(..., N_pad, d) template-order array -> (..., num_nodes, d) in the
        dataset's node order (the padded rows dropped)."""
        return per_node[..., : self.num_nodes, :]


def prepare_trajectory(
    traj: Trajectory,
    meta: Dict[str, Any],
    spec: FieldSpec,
    node_bucket: Optional[int] = None,
    edge_bucket: Optional[int] = None,
    spatial_reorder: bool = False,
    device: torch.device = torch.device("cpu"),
) -> PreparedTrajectory:
    """Template and padded ``(T, N_pad, dim)`` field stacks on ``device``."""
    if spatial_reorder:
        raise NotImplementedError(
            "spatial_reorder is a TPU banding aid that mgn_tpu_torch does not "
            "port (ROADMAP.md, queue A)")
    tmin, tmax = node_type_range(meta)
    template = build_template(
        traj.mesh_pos, traj.node_type,
        cells=traj.cells, edges=traj.edges,
        type_min=tmin, type_max=tmax,
        node_bucket=node_bucket, edge_bucket=edge_bucket,
    ).to(device)
    n_pad = template.num_nodes
    fields = {}
    for f in spec.fields:
        arr = traj.fields[f]  # (T, N, dim)
        padded = np.zeros((arr.shape[0], n_pad, arr.shape[2]), np.float32)
        padded[:, : arr.shape[1]] = arr
        fields[f] = torch.from_numpy(padded).to(device)
    return PreparedTrajectory(
        template=template,
        fields=fields,
        times=torch.as_tensor(np.asarray(traj.times, np.float32), device=device),
        num_nodes=traj.num_nodes,
        num_steps=traj.num_steps,
    )
