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

:func:`build_world_edges` is the device half the cloth family needs: the
per-step radius query that builds the dynamic world-edge set.

:func:`build_template` sorts its edges by receiver and, inside a row, by
sender, as the JAX package's native route orders them.  It takes them from
the native graph builder where that loads (:mod:`mgn_tpu_torch.ops.native`),
else from ``cells_to_edges`` / ``parse_edges`` and a sort by (receiver,
sender); the two routes give the same template bit for bit, and
:func:`mgn_tpu_torch.ops.native.route` says which one ran.

Not ported: the TPU banding plan (``fused_plan``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "MeshGraph",
    "GraphTemplate",
    "cells_to_edges",
    "parse_edges",
    "grid_edges",
    "sort_edges_by_receiver",
    "csr_row_offsets",
    "sender_csr",
    "relative_mesh_features",
    "pad_to",
    "bucket_size",
    "build_template",
    "build_world_edges",
    "world_centre",
    "within_radius",
    "first_hits",
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


def grid_edges(
    dims: Sequence[int],
    node_type: Optional[np.ndarray] = None,
    no_edges_node_types: Sequence[int] = (),
) -> tuple[np.ndarray, np.ndarray]:
    """Structured-grid nearest-neighbour edges for 1-D, 2-D and 3-D grids
    (C order over ``dims``, axes of extent 1 dropped), as bidirectional
    edge lists.  Nodes whose type is in ``no_edges_node_types`` get no grid
    edge and a self-loop instead, so they are not isolated."""
    dims = [int(d) for d in dims if int(d) > 1] or [1]
    n = int(np.prod(dims))
    idx = np.arange(n).reshape(dims)
    pairs = []
    for axis in range(len(dims)):
        a = np.take(idx, np.arange(dims[axis] - 1), axis=axis).reshape(-1)
        b = np.take(idx, np.arange(1, dims[axis]), axis=axis).reshape(-1)
        pairs.append(np.stack([a, b], axis=1))
    edges = np.concatenate(pairs, axis=0)
    if node_type is not None and len(no_edges_node_types) > 0:
        node_type = np.asarray(node_type).reshape(-1)
        excluded = np.isin(node_type, np.asarray(list(no_edges_node_types)))
        keep = ~(excluded[edges[:, 0]] | excluded[edges[:, 1]])
        edges = edges[keep]
        loops = np.nonzero(excluded)[0]
        if loops.size:
            edges = np.concatenate([edges, np.stack([loops, loops], axis=1)], axis=0)
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

    from mgn_tpu_torch.ops import native

    if cells is not None:
        conn = np.asarray(cells)
    elif edges is not None:
        conn = np.asarray(edges)
    else:
        raise ValueError("need cells or edges to build graph connectivity")
    if conn.min() == 1 and conn.max() == n:
        conn = conn - 1
    if conn.size and (conn.min() < 0 or conn.max() >= n):
        raise ValueError(f"connectivity indexes nodes outside [0, {n})")
    if native.available():  # sorted by (receiver, sender)
        if cells is None and conn.shape[1] != 2:
            conn = conn.T
        senders, receivers = native.cells_to_edges_native(conn)
    else:
        senders, receivers = cells_to_edges(conn) if cells is not None else parse_edges(conn)
        order = np.lexsort((senders, receivers))
        senders, receivers = senders[order].astype(np.int32), receivers[order].astype(np.int32)
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


def build_world_edges(
    world_pos: torch.Tensor,
    node_mask: torch.Tensor,
    radius: float,
    capacity: int,
    exclude_senders: Optional[torch.Tensor] = None,
    exclude_receivers: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dynamic world edges (cloth / contact models) on the tensors' device:
    every ordered pair of distinct valid nodes closer than ``radius`` in
    world space, except the pairs ``(exclude_senders, exclude_receivers)``
    (the mesh edges), compacted into a fixed ``capacity`` buffer.

    The semantics of ``mgn_tpu/core/graph.py:build_world_edges``: positions
    centred on the masked mean, squared distances by the Gram identity
    ``|a|^2 + |b|^2 - 2 a.b`` in f32, and the first ``capacity`` hits by flat
    index ``s * n + r`` kept (a ``topk`` over int32 keys, so the shapes stay
    static and nothing waits on the host).  Returns ``(senders, receivers,
    mask)``, each ``(capacity,)``; slots past the hits are ``0, 0, False``.

    The Gram sum is written out as elementwise products and sums, one
    rounding each, so it never meets a tensor core (no TF32, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says) and the CPU and the GPU
    give the same bits; the centre is summed in f64 for the same reason.
    A pair within rounding of the radius can still fall on another side than
    in the JAX package, whose f32 sums run in another order.
    """
    n = world_pos.shape[0]
    if n * n >= 2 ** 31:
        raise ValueError(f"world-edge ranking key overflows int32 at n={n} (n*n >= 2^31, "
                         "about 46,341 nodes)")
    mask = node_mask.to(torch.bool)
    wp = world_pos.float()
    hit = within_radius(wp, wp, world_centre(wp, mask), radius) & mask[:, None] & mask[None, :]
    hit.fill_diagonal_(False)
    if exclude_senders is not None:
        hit[exclude_senders.long(), exclude_receivers.long()] = False
    return first_hits(hit, capacity)


def world_centre(world_pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked mean of the positions, ``(dim,)`` f32, summed in f64 (the
    world-edge builders centre on it)."""
    return (torch.where(mask[:, None], world_pos.float(), 0.0).double().mean(dim=0)
            / torch.clamp(mask.double().mean(), min=1e-9)).float()


def within_radius(senders_pos: torch.Tensor, receivers_pos: torch.Tensor,
                  centre: torch.Tensor, radius: float) -> torch.Tensor:
    """``(S, R)`` bool: pairs closer than ``radius``, by the Gram identity
    ``|a|^2 + |b|^2 - 2 a.b`` on the centred f32 positions, written out as
    elementwise products and sums (one rounding each: no tensor core)."""
    a = (senders_pos.float() - centre).unbind(dim=1)
    b = (receivers_pos.float() - centre).unbind(dim=1)
    sq_a, sq_b, gram = a[0] * a[0], b[0] * b[0], a[0][:, None] * b[0][None, :]
    for ca, cb in zip(a[1:], b[1:]):
        sq_a = sq_a + ca * ca
        sq_b = sq_b + cb * cb
        gram = gram + ca[:, None] * cb[None, :]
    return (sq_a[:, None] + sq_b[None, :] - 2.0 * gram) < radius * radius


def first_hits(hit: torch.Tensor, capacity: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first ``capacity`` true entries of the ``(S, R)`` ``hit`` by flat
    index ``s * R + r`` (a ``topk`` over int32 keys: static shapes, no host
    wait), as ``(senders, receivers, mask)``, each ``(capacity,)``; slots
    past the hits are ``0, 0, False``.  ``S * R`` must be below 2^31."""
    n_rows, n_cols = hit.shape
    dev = hit.device
    flat = hit.reshape(-1)
    # hits ranked first, earliest flat index first
    key = torch.where(flat, -torch.arange(n_rows * n_cols, dtype=torch.int32, device=dev),
                      torch.iinfo(torch.int32).min)
    k = min(capacity, n_rows * n_cols)
    idx = torch.topk(key, k).indices
    if k < capacity:  # tiny meshes: pad up to the static capacity
        idx = torch.cat([idx, idx.new_zeros((capacity - k,))])
    count = torch.clamp(flat.sum(), max=capacity)
    valid = torch.arange(capacity, device=dev) < count
    zero = idx.new_zeros(())
    senders = torch.where(valid, idx // n_cols, zero).to(torch.int32)
    receivers = torch.where(valid, idx % n_cols, zero).to(torch.int32)
    return senders, receivers, valid
