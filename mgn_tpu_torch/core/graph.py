"""Static-shape graph containers and host-side feature builders.

The port's copy of the host half of ``mgn_tpu/core/graph.py``.  Every graph
is padded to a bucketed ``(num_nodes, num_edges)`` capacity and carries
validity masks; layout is node-major ``(N, F)``.  Edges are sorted by
receiver, so each node's incoming edges are one contiguous CSR row — the
layout the segment-sum kernel (:mod:`mgn_tpu_torch.ops.csr_segment`) reduces
without atomics.

Padding contract (shared with the JAX package): dead edges point at the last
padded node ``N_pad - 1`` as sender and receiver, and ``row_offsets[-1] ==
E_pad``, so real nodes never receive a dead edge and the receiver order stays
sorted.

The port's template also carries a sender-side CSR (``sender_perm``: the
edges in stable sender order; ``sender_offsets``: its row offsets), which the
processor's backward uses to sum cotangents by sender without atomics
(:func:`sender_csr`).  The JAX package has no such field.

Not ported: the TPU banding plan (``fused_plan``) and the ``native`` ctypes
edge builder.  The edge order inside one receiver row is that of
``cells_to_edges`` followed by a stable sort; the JAX package's native route
orders a row by sender instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "MeshGraph",
    "GraphTemplate",
    "cells_to_edges",
    "parse_edges",
    "sort_edges_by_receiver",
    "csr_row_offsets",
    "sender_csr",
    "relative_mesh_features",
    "pad_to",
    "bucket_size",
    "build_template",
]


@dataclasses.dataclass
class MeshGraph:
    """A batch-of-one simulation graph with padded, static shapes."""

    node_features: torch.Tensor  # (N_pad, F_n) float
    edge_features: torch.Tensor  # (E_pad, F_e) float
    senders: torch.Tensor  # (E_pad,) int32
    receivers: torch.Tensor  # (E_pad,) int32
    node_mask: torch.Tensor  # (N_pad,) bool — True for real nodes
    edge_mask: torch.Tensor  # (E_pad,) bool — True for real edges

    @property
    def num_nodes(self) -> int:
        return self.node_features.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_features.shape[0]


@dataclasses.dataclass
class GraphTemplate:
    """Per-trajectory static graph structure: one-hot node types,
    receiver-sorted connectivity with CSR offsets, and the mesh-space edge
    features ``[rel_pos, |rel_pos|]``."""

    node_type_onehot: torch.Tensor  # (N_pad, T) float32
    mesh_edge_features: torch.Tensor  # (E_pad, D+1) float32
    senders: torch.Tensor  # (E_pad,) int32, edges sorted by receiver
    receivers: torch.Tensor  # (E_pad,) int32, nondecreasing
    row_offsets: torch.Tensor  # (N_pad+1,) int32 CSR offsets into edges
    node_mask: torch.Tensor  # (N_pad,) bool
    edge_mask: torch.Tensor  # (E_pad,) bool
    node_type: torch.Tensor  # (N_pad,) int32 raw node type (padded with -1)
    sender_perm: torch.Tensor  # (E_pad,) int32 edge ids in stable sender order
    sender_offsets: torch.Tensor  # (N_pad+1,) int32 CSR offsets into sender_perm

    @property
    def num_nodes(self) -> int:
        return self.node_type_onehot.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    def to(self, device) -> "GraphTemplate":
        return GraphTemplate(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


def cells_to_edges(cells: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Cell connectivity (C, K) -> unique bidirectional edge lists (0-based).

    Every pair of vertices within a cell becomes an undirected edge; the
    result holds both directions of each unique undirected edge.  Self-loops
    are kept once.
    """
    cells = np.asarray(cells)
    if cells.ndim != 2:
        raise ValueError(f"cells must be (num_cells, K), got {cells.shape}")
    k = cells.shape[1]
    pairs = []
    for i in range(k):
        for j in range(i + 1, k):
            pairs.append(cells[:, [i, j]])
    edges = np.concatenate(pairs, axis=0).astype(np.int64)
    lo = edges.min(axis=1)
    hi = edges.max(axis=1)
    und = np.unique(np.stack([lo, hi], axis=1), axis=0)
    loops = und[:, 0] == und[:, 1]
    proper = und[~loops]
    senders = np.concatenate([proper[:, 0], proper[:, 1], und[loops, 0]])
    receivers = np.concatenate([proper[:, 1], proper[:, 0], und[loops, 1]])
    return senders.astype(np.int32), receivers.astype(np.int32)


def parse_edges(edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Explicit edge array (E, 2) (or (2, E)) -> bidirectional edge lists."""
    edges = np.asarray(edges)
    if edges.ndim != 2:
        raise ValueError(f"edges must be 2-D, got {edges.shape}")
    if edges.shape[0] == 2 and edges.shape[1] != 2:
        edges = edges.T
    return cells_to_edges(edges)


def sort_edges_by_receiver(
    senders: np.ndarray, receivers: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Stable-sort edge lists by receiver (CSR order)."""
    order = np.argsort(receivers, kind="stable")
    return senders[order].astype(np.int32), receivers[order].astype(np.int32)


def csr_row_offsets(receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """Row offsets (num_nodes+1,) for receiver-sorted edges."""
    counts = np.bincount(receivers, minlength=num_nodes)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def sender_csr(senders: np.ndarray, num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Sender-side CSR of padded edge lists: ``(perm (E,), offsets (num_nodes+1,))``
    with ``senders[perm]`` nondecreasing (stable) and node ``n``'s outgoing
    edges at ``perm[offsets[n]:offsets[n+1]]``, both int32."""
    senders = np.asarray(senders)
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    return perm, csr_row_offsets(senders[perm], num_nodes)


def relative_mesh_features(
    mesh_pos: np.ndarray, senders: np.ndarray, receivers: np.ndarray
) -> np.ndarray:
    """Mesh-space edge features ``[pos_s - pos_r, |pos_s - pos_r|]`` (E, D+1)."""
    mesh_pos = np.asarray(mesh_pos, dtype=np.float32)
    rel = mesh_pos[senders] - mesh_pos[receivers]
    norm = np.linalg.norm(rel, axis=1, keepdims=True)
    return np.concatenate([rel, norm], axis=1).astype(np.float32)


def bucket_size(n: int, multiple: int = 128, slack: float = 1.0) -> int:
    """Round ``n * slack`` up to a multiple."""
    target = int(np.ceil(n * slack))
    return int(-(-target // multiple) * multiple)


def pad_to(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``arr`` to ``size`` with ``fill``."""
    if arr.shape[0] > size:
        raise ValueError(f"cannot pad {arr.shape[0]} down to {size}")
    if arr.shape[0] == size:
        return arr
    pad = np.full((size - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def build_template(
    mesh_pos: np.ndarray,
    node_type: np.ndarray,
    cells: Optional[np.ndarray] = None,
    edges: Optional[np.ndarray] = None,
    type_min: int = 0,
    type_max: int = 6,
    node_bucket: Optional[int] = None,
    edge_bucket: Optional[int] = None,
    bucket_multiple: int = 128,
    edge_bucket_multiple: int = 1024,
) -> GraphTemplate:
    """Build the per-trajectory static graph structure (CPU tensors).

    Accepts 0- or 1-based connectivity (1-based inputs are detected by
    max index == num_nodes together with no 0 index and shifted down).
    """
    mesh_pos = np.asarray(mesh_pos, dtype=np.float32)
    node_type = np.asarray(node_type).reshape(-1).astype(np.int32)
    n = mesh_pos.shape[0]
    if node_type.shape[0] != n:
        raise ValueError(f"mesh_pos has {n} nodes but node_type has {node_type.shape[0]}")

    if cells is not None:
        conn = np.asarray(cells)
        if conn.min() == 1 and conn.max() == n:
            conn = conn - 1
        senders, receivers = cells_to_edges(conn)
    elif edges is not None:
        conn = np.asarray(edges)
        if conn.min() == 1 and conn.max() == n:
            conn = conn - 1
        senders, receivers = parse_edges(conn)
    else:
        raise ValueError("need cells or edges to build graph connectivity")
    if senders.size and (min(senders.min(), receivers.min()) < 0
                         or max(senders.max(), receivers.max()) >= n):
        raise ValueError(f"connectivity indexes nodes outside [0, {n})")
    senders, receivers = sort_edges_by_receiver(senders, receivers)
    e = senders.shape[0]

    n_pad = node_bucket or bucket_size(n + 1, bucket_multiple)
    if n_pad <= n:
        raise ValueError("node bucket must leave at least one padded slot")
    e_pad = edge_bucket or bucket_size(e, edge_bucket_multiple)
    if e_pad < e:
        raise ValueError(f"edge bucket {e_pad} is smaller than the {e} edges")

    # dead edges all land on the final padded node
    senders_p = pad_to(senders, e_pad, fill=n_pad - 1)
    receivers_p = pad_to(receivers, e_pad, fill=n_pad - 1)
    row = csr_row_offsets(receivers, n)
    row_offsets = np.concatenate(
        [row, np.full((n_pad - n,), e, dtype=np.int32)]
    ).astype(np.int32)
    row_offsets[-1] = e_pad

    onehot = np.zeros((n_pad, type_max - type_min + 1), dtype=np.float32)
    onehot[np.arange(n), node_type - type_min] = 1.0

    mef = pad_to(relative_mesh_features(mesh_pos, senders, receivers), e_pad, fill=0)
    sender_perm, sender_offsets = sender_csr(senders_p, n_pad)

    return GraphTemplate(
        node_type_onehot=torch.from_numpy(onehot),
        mesh_edge_features=torch.from_numpy(mef),
        senders=torch.from_numpy(senders_p),
        receivers=torch.from_numpy(receivers_p),
        row_offsets=torch.from_numpy(row_offsets),
        node_mask=torch.from_numpy(np.arange(n_pad) < n),
        edge_mask=torch.from_numpy(np.arange(e_pad) < e),
        node_type=torch.from_numpy(pad_to(node_type, n_pad, fill=-1)),
        sender_perm=torch.from_numpy(sender_perm),
        sender_offsets=torch.from_numpy(sender_offsets),
    )
