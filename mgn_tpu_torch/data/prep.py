"""Host -> device trajectory preparation: the port's copy of
``mgn_tpu/data/prep.py`` (``prepare_trajectory``, ``PreparedTrajectory``,
``common_buckets``, ``dataset_buckets`` and the byte-capped ``BytesLRU``).

Builds the static :class:`GraphTemplate` and pads every dynamic field to the
template's node bucket.  Spatial reordering is a TPU banding aid that the
GPU kernels do not need; it is not ported (``spatial_reorder=True`` raises).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mgn_tpu_torch.core.graph import (GraphTemplate, bucket_size, build_template,
                                      cells_to_edges, parse_edges)
from mgn_tpu_torch.data.meta import node_type_range
from mgn_tpu_torch.data.pipeline import Trajectory
from mgn_tpu_torch.train.common import FieldSpec

__all__ = ["PreparedTrajectory", "prepare_trajectory", "common_buckets", "dataset_buckets",
           "BytesLRU"]


class BytesLRU:
    """Byte-capped LRU over values holding tensors or arrays (host or device).

    Bounds the device memory of the prepared-trajectory cache on real-size
    datasets.  Evicted entries are dropped; their device memory returns to
    PyTorch's allocator when the last reference dies.
    """

    def __init__(self, cap_bytes: int):
        self.cap = int(cap_bytes)
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes: Dict[Any, int] = {}
        self.total = 0

    @staticmethod
    def value_bytes(val) -> int:
        if isinstance(val, torch.Tensor):
            return val.numel() * val.element_size()
        nb = getattr(val, "nbytes", None)
        if nb is not None and not callable(nb):
            return int(nb)
        if dataclasses.is_dataclass(val) and not isinstance(val, type):
            return sum(BytesLRU.value_bytes(getattr(val, f.name))
                       for f in dataclasses.fields(val))
        if isinstance(val, dict):
            return sum(BytesLRU.value_bytes(v) for v in val.values())
        if isinstance(val, (list, tuple)):
            return sum(BytesLRU.value_bytes(v) for v in val)
        return 0  # opaque non-array leaf

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def get(self, key, build: Callable[[], Any]):
        """Return the cached value, building (and inserting) it on miss.
        Inserting evicts least-recently-used entries until under the cap; a
        single over-cap value still caches alone."""
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        val = build()
        nb = self.value_bytes(val)
        while self._d and self.total + nb > self.cap:
            k, _ = self._d.popitem(last=False)
            self.total -= self._bytes.pop(k)
        self._d[key] = val
        self._bytes[key] = nb
        self.total += nb
        return val


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

    @property
    def nbytes(self) -> int:
        """Total tensor bytes (template + field stacks + times) — the unit
        the byte-capped trajectory cache accounts in."""
        return (BytesLRU.value_bytes(self.template) + BytesLRU.value_bytes(self.fields)
                + BytesLRU.value_bytes(self.times))

    def unpermute(self, per_node: np.ndarray) -> np.ndarray:
        """(..., N_pad, d) template-order array -> (..., num_nodes, d) in the
        dataset's node order (the padded rows dropped)."""
        return per_node[..., : self.num_nodes, :]


def common_buckets(trajs, meta: Dict[str, Any], node_multiple: int = 128,
                   edge_multiple: int = 1024) -> Tuple[int, int]:
    """Shared (node_bucket, edge_bucket) across trajectories, so every
    trajectory of a run has the same padded shapes."""
    max_n, max_e = 0, 0
    for t in trajs:
        max_n = max(max_n, t.num_nodes)
        if t.cells is not None:
            s, _ = cells_to_edges(t.cells)
        elif t.edges is not None:
            s, _ = parse_edges(t.edges)
        else:
            raise ValueError("trajectory without cells or edges")
        max_e = max(max_e, len(s))
    return bucket_size(max_n + 1, node_multiple), bucket_size(max_e, edge_multiple)


def dataset_buckets(dataset, meta: Dict[str, Any], node_multiple: int,
                    edge_multiple: int) -> Tuple[int, int]:
    """:func:`common_buckets` over every trajectory of a dataset's train and
    valid splits, so a later, larger trajectory can never overflow the
    shared buckets mid-training.  Shape and connectivity reads only
    (``Dataset.structure``)."""
    structs = [dataset.structure(i) for i in range(dataset.num_trajectories)]
    structs += [dataset.structure(i, valid=True) for i in range(dataset.num_valid)]
    return common_buckets(structs, meta, node_multiple, edge_multiple)


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
