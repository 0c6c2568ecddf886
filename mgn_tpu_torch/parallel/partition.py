"""Spatial graph partitioning for graph-parallel message passing: the port's
copy of the numpy code of ``mgn_tpu/parallel/partition.py``.

Host-side, once per trajectory:

- **recursive coordinate bisection** of the nodes, then FM boundary
  refinement of the cut (:func:`refine_partition`);
- node reordering so each part is contiguous, every part padded to the same
  ``N_p``;
- each edge assigned to its **receiver's** part, receiver-sorted with CSR
  row offsets over part-local receivers; senders kept as global (reordered,
  padded) ids ``part * N_p + local``;
- the exchange plans: the classic per-round halo (:func:`add_halo_plan`,
  which rows part ``p`` sends part ``q`` each round) and the k-deep ghost
  zone (:func:`add_deep_halo_plan`, one exchange per ``rounds`` rounds).

Every array keeps the JAX package's layout and dtype, so that a test can
hold each table against ``mgn_tpu.parallel.partition``'s bit for bit.  Two
differences:

- :func:`refine_partition` skips a move that would shrink its source part
  below ``floor(n / num_parts * (1 - balance_slack))``, the lower bound that
  mirrors the destination cap (the JAX function has none and can drain a
  part);
- the TPU devices are left out: the banding plans (``add_fused_plans``,
  ``FusedPlan``, the ``fused_*``/``frel_*`` fields and a telescope stage's
  ``frel_*``/``band_*``/``chunk``, ``build_fused``, ``max_band_*``) and the
  interior/boundary edge split of ``add_halo_plan`` (``split_boundary``, an
  XLA scheduling aid).  The port's kernels gather rows directly.

The deep plan's telescoped stages (:class:`TelescopeStage`,
``add_deep_halo_plan(telescope=)``) are kept: later rounds of a segment run
on nested, shrinking tables.

:func:`kernel_tables` turns one part's plan into the tensors the kernels
take, checking their invariants once.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mgn_tpu_torch.core.graph import (bucket_size, csr_row_offsets, relative_mesh_features,
                                      sender_csr)

__all__ = ["PartitionedTemplate", "DeepHaloPlan", "TelescopeStage", "KernelTables",
           "bisect_partition", "refine_partition", "partition_template", "add_halo_plan",
           "add_deep_halo_plan", "deep_depth", "global_ids", "kernel_tables"]


@dataclasses.dataclass
class PartitionedTemplate:
    """Per-part stacked graph structure (leading axis = parts)."""

    node_type_onehot: np.ndarray  # (P, N_p, T)
    mesh_edge_features: np.ndarray  # (P, E_p, D+1)
    senders_global: np.ndarray  # (P, E_p) int32, indices into the padded global order
    receivers_local: np.ndarray  # (P, E_p) int32, part-local, receiver-sorted
    row_offsets: np.ndarray  # (P, N_p+1) int32
    node_mask: np.ndarray  # (P, N_p) bool
    edge_mask: np.ndarray  # (P, E_p) bool
    node_type: np.ndarray  # (P, N_p) int32 (padded -1)
    perm: np.ndarray  # (N,) original node id -> position in the reordered order
    num_parts: int
    part_nodes: int  # N_p
    # --- classic halo exchange plan (None until add_halo_plan) ---------------
    halo_serve: Optional[np.ndarray] = None  # (P, P, H) local slots p sends q
    halo_serve_mask: Optional[np.ndarray] = None  # (P, P, H) bool
    senders_halo: Optional[np.ndarray] = None  # (P, E_p) into [own (N_p); halo (P*H)]
    halo_size: int = 0  # H
    # --- k-deep ghost-zone plan (None until attached) -------------------------
    deep: Optional["DeepHaloPlan"] = None

    @property
    def num_nodes_padded(self) -> int:
        return self.num_parts * self.part_nodes


def bisect_partition(mesh_pos: np.ndarray, num_parts: int) -> np.ndarray:
    """Recursive coordinate bisection -> part id per node.

    ``num_parts`` must be a power of two.  Splits along the widest axis at the
    median, recursively; parts are balanced to within one node.
    """
    n = mesh_pos.shape[0]
    if num_parts & (num_parts - 1):
        raise ValueError(f"num_parts must be a power of two, got {num_parts}")
    part = np.zeros(n, np.int32)

    def rec(idx: np.ndarray, base: int, k: int):
        if k == 1:
            part[idx] = base
            return
        pos = mesh_pos[idx]
        axis = int(np.argmax(pos.max(0) - pos.min(0)))
        order = idx[np.argsort(pos[:, axis], kind="stable")]
        half = len(order) // 2
        rec(order[:half], base, k // 2)
        rec(order[half:], base + k // 2, k // 2)

    rec(np.arange(n), 0, num_parts)
    return part


def refine_partition(part: np.ndarray, senders: np.ndarray, receivers: np.ndarray,
                     num_parts: int, balance_slack: float = 0.03,
                     passes: int = 8) -> np.ndarray:
    """FM-style boundary refinement of a node partition.

    Greedy gain passes: a boundary node moves to the neighbouring part
    holding most of its edges when that strictly reduces the edge cut,
    subject to a ``balance_slack`` band on part sizes: no part grows above
    ``ceil(n / P * (1 + slack))`` nor shrinks below ``floor(n / P * (1 -
    slack))``.  Within each pass moves apply in descending gain with a
    touched-neighbourhood guard (two adjacent nodes never both move in one
    pass), so every applied move's gain is exact and the cut decreases
    monotonically.
    """
    part = np.asarray(part, np.int32).copy()
    s = np.asarray(senders, np.int64).reshape(-1)
    r = np.asarray(receivers, np.int64).reshape(-1)
    n = part.shape[0]
    cap = int(np.ceil(n / num_parts * (1.0 + balance_slack)))
    floor = int(np.floor(n / num_parts * (1.0 - balance_slack)))
    sizes = np.bincount(part, minlength=num_parts)
    # CSR adjacency over the (already bidirectional) edge list, receiver side
    order = np.argsort(r, kind="stable")
    adj = s[order]
    row = np.zeros(n + 1, np.int64)
    np.add.at(row, r + 1, 1)
    row = np.cumsum(row)

    for _ in range(passes):
        # cnt[v, q] = number of neighbours of v in part q
        cnt = np.zeros((n, num_parts), np.int32)
        np.add.at(cnt, (r, part[s]), 1)
        own = cnt[np.arange(n), part]
        best_q = np.argmax(cnt, axis=1).astype(np.int32)
        gain = cnt[np.arange(n), best_q] - own
        cand = np.nonzero((gain > 0) & (best_q != part))[0]
        if not len(cand):
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        touched = np.zeros(n, bool)
        moved = 0
        for v in cand:
            if touched[v]:
                continue
            q = best_q[v]
            if sizes[q] >= cap or sizes[part[v]] - 1 < floor:
                continue
            sizes[part[v]] -= 1
            sizes[q] += 1
            part[v] = q
            moved += 1
            touched[v] = True
            touched[adj[row[v]:row[v + 1]]] = True
        if not moved:
            break
    return part


def partition_template(mesh_pos: np.ndarray, node_type: np.ndarray, senders: np.ndarray,
                       receivers: np.ndarray, num_parts: int, type_min: int = 0,
                       type_max: int = 6, part_node_bucket: Optional[int] = None,
                       part_edge_bucket: Optional[int] = None, bucket_multiple: int = 128,
                       spatial_order: bool = False, refine: bool = True
                       ) -> PartitionedTemplate:
    """Partition an edge list (0-based, any order) into P stacked shards.

    ``spatial_order``: order nodes within each part by a spatial sweep
    (widest-axis lexsort) instead of original index.  ``refine``: FM boundary
    refinement of the bisection cut (:func:`refine_partition`): a smaller cut
    means smaller halos and a smaller k-deep ghost zone."""
    mesh_pos = np.asarray(mesh_pos, np.float32)
    node_type = np.asarray(node_type).reshape(-1).astype(np.int32)
    n = mesh_pos.shape[0]
    part = bisect_partition(mesh_pos, num_parts)
    if refine and num_parts > 1:
        part = refine_partition(part, senders, receivers, num_parts)

    # reorder nodes: sort by (part, original index | spatial sweep rank)
    if spatial_order:
        extent = mesh_pos.max(0) - mesh_pos.min(0)
        axes_ = np.argsort(-extent)
        sweep = np.lexsort(tuple(mesh_pos[:, a] for a in reversed(axes_)))
        rank = np.empty(n, np.int64)
        rank[sweep] = np.arange(n)
        order = np.lexsort((rank, part))  # new position -> original id
    else:
        order = np.lexsort((np.arange(n), part))
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)  # original id -> new position in the global order

    counts = np.bincount(part, minlength=num_parts)
    n_p = part_node_bucket or bucket_size(int(counts.max()) + 1, bucket_multiple)
    if n_p <= counts.max():
        raise ValueError("part node bucket too small")

    offsets = np.concatenate([[0], np.cumsum(counts)])
    local = perm - offsets[part[np.arange(n)]]
    gid = part.astype(np.int64) * n_p + local  # padded global id

    edge_part = part[receivers]
    ecounts = np.bincount(edge_part, minlength=num_parts)
    e_p = part_edge_bucket or bucket_size(int(ecounts.max()), bucket_multiple)

    t_depth = type_max - type_min + 1
    onehot = np.zeros((num_parts, n_p, t_depth), np.float32)
    nt_out = np.full((num_parts, n_p), -1, np.int32)
    nmask = np.zeros((num_parts, n_p), bool)
    for p in range(num_parts):
        ids = np.nonzero(part == p)[0]
        loc = local[ids]
        onehot[p, loc, node_type[ids] - type_min] = 1.0
        nt_out[p, loc] = node_type[ids]
        nmask[p, loc] = True

    mef_all = relative_mesh_features(mesh_pos, senders, receivers)
    sg = np.full((num_parts, e_p), 0, np.int32)
    rl = np.full((num_parts, e_p), n_p - 1, np.int32)
    mef = np.zeros((num_parts, e_p, mef_all.shape[1]), np.float32)
    emask = np.zeros((num_parts, e_p), bool)
    rows = np.zeros((num_parts, n_p + 1), np.int32)
    for p in range(num_parts):
        eid = np.nonzero(edge_part == p)[0]
        rloc = local[receivers[eid]].astype(np.int32)
        o = np.argsort(rloc, kind="stable")
        eid = eid[o]
        rloc = rloc[o]
        k = len(eid)
        sg[p, :k] = gid[senders[eid]].astype(np.int32)
        rl[p, :k] = rloc
        mef[p, :k] = mef_all[eid]
        emask[p, :k] = True
        rows[p, :n_p] = csr_row_offsets(rloc, n_p - 1)
        rows[p, n_p] = e_p  # dead edges land on the last padded slot

    return PartitionedTemplate(
        node_type_onehot=onehot, mesh_edge_features=mef, senders_global=sg,
        receivers_local=rl, row_offsets=rows, node_mask=nmask, edge_mask=emask,
        node_type=nt_out, perm=perm.astype(np.int64), num_parts=num_parts, part_nodes=n_p)


def add_halo_plan(pt: PartitionedTemplate, halo_multiple: int = 8,
                  force_halo_size: Optional[int] = None) -> PartitionedTemplate:
    """The classic boundary-halo exchange plan (host-side, once).

    For each ordered part pair (p, q) the plan records which of p's local
    node slots part q's edges reference ("p serves q"); each round the parts
    exchange only those rows through one ``all_to_all`` instead of
    all-gathering every node.  Sender indices are rewritten into the extended
    table ``[own nodes (N_p); received halo (P*H)]``.  The arrays are those
    of ``mgn_tpu``'s ``add_halo_plan(split_boundary=False)``."""
    P, n_p = pt.num_parts, pt.part_nodes
    # requests[p][q] = sorted unique local slots of q referenced by p's edges
    requests = [[np.zeros(0, np.int64) for _ in range(P)] for _ in range(P)]
    for p in range(P):
        e = pt.edge_mask[p]
        sg = pt.senders_global[p][e].astype(np.int64)
        owner = sg // n_p
        local = sg % n_p
        for q in range(P):
            if q != p:
                requests[p][q] = np.unique(local[owner == q])
    h = max((len(requests[p][q]) for p in range(P) for q in range(P)), default=0)
    h = max(halo_multiple, int(-(-h // halo_multiple) * halo_multiple))
    if force_halo_size is not None:
        if force_halo_size < h:
            raise ValueError(f"forced halo size {force_halo_size} < required {h}")
        h = force_halo_size
    serve, serve_mask = _serve_tables(requests, P, h)

    # extended-table sender indices: own slot, or N_p + q*h + position in request
    senders_halo = np.zeros_like(pt.senders_global)
    for p in range(P):
        sg = pt.senders_global[p].astype(np.int64)
        owner = sg // n_p
        local = sg % n_p
        out = np.zeros_like(sg)
        own = owner == p
        out[own] = local[own]
        for q in range(P):
            sel = owner == q
            if q != p and sel.any():
                out[sel] = n_p + q * h + np.searchsorted(requests[p][q], local[sel])
        out[~pt.edge_mask[p]] = n_p - 1  # dead edges: the own padded slot
        senders_halo[p] = out.astype(np.int32)
    return dataclasses.replace(pt, halo_serve=serve, halo_serve_mask=serve_mask,
                               senders_halo=senders_halo, halo_size=h)


def _serve_tables(requests, P: int, h: int):
    """``serve[p, q]``: the local slots part ``q`` requested of part ``p``."""
    serve = np.zeros((P, P, h), np.int32)
    serve_mask = np.zeros((P, P, h), bool)
    for p in range(P):
        for q in range(P):
            req = requests[q][p]
            serve[p, q, : len(req)] = req
            serve_mask[p, q, : len(req)] = True
    return serve, serve_mask


# --- k-deep halo (ghost zones): exchange once per k rounds -------------------

@dataclasses.dataclass
class TelescopeStage:
    """One shrinking stage of a telescoped deep segment.  After ``a``
    rounds since the exchange only nodes within distance ``depth - a`` of
    the owned set (and edges whose receiver is within ``depth - a - 1``)
    can still reach the owned rows, so the stage's rounds run on that nested
    table: the ghost work averaged over the rounds falls to about half of
    the full-depth ring's, with no more exchanges (the exactness argument of
    :class:`DeepHaloPlan` holds per stage at the reduced depth).  Arrays are
    stacked on a leading parts axis; ``nremap`` maps this stage's node rows
    into the previous stage's table (pad rows to its first pad row),
    ``eremap`` its edge rows into the stage-0 edge table (pad slots to
    ``E_ext``, one past its end: they read zero and are not written back)."""

    rounds: int
    depth: int
    nremap: np.ndarray     # (P, n_ext_s) int32 -> previous stage's rows
    eremap: np.ndarray     # (P, e_ext_s) int32 -> stage-0 edge slots
    own_pos: np.ndarray    # (P, N_p) int32
    senders: np.ndarray    # (P, e_ext_s) int32, table-local
    receivers: np.ndarray  # (P, e_ext_s) int32, table-local, receiver-sorted
    edge_mask: np.ndarray  # (P, e_ext_s) bool
    rows: np.ndarray       # (P, n_ext_s+1) int32 CSR
    n_ext: int


@dataclasses.dataclass
class DeepHaloPlan:
    """Per-part k-deep ghost-zone plan (leading axis = parts).

    Each part's node table is extended with every node within graph
    distance ``depth`` of its owned set, the edge table with every edge whose
    receiver is within ``depth - 1``, and ``rounds`` processor rounds run
    locally between exchanges.  After a fresh exchange a node at distance d
    stays exact for the first ``depth - d`` rounds, so owned nodes (d = 0)
    are exact after ``rounds <= depth`` rounds.  Edge latents never travel:
    they are recomputed in the halo region, which is why a multi-segment
    schedule needs ``depth = 2 * rounds - 1``; a single segment covering all
    ``mps`` rounds starts from freshly encoded edge latents and needs only
    ``depth = rounds``.  ``src`` places ``[own latents; received halo; one
    zero row]`` into the extended table, sorted by padded global id.
    """

    src: np.ndarray        # (P, N_ext) int32 -> concat([own (N_p); recv (P*H); 0-row])
    own_pos: np.ndarray    # (P, N_p) int32: own slot l lives at ext row own_pos[l]
    serve: np.ndarray      # (P, P, H) int32 own-local slots part p sends part q
    serve_mask: np.ndarray  # (P, P, H) bool
    senders: np.ndarray    # (P, E_ext) int32, ext-local
    receivers: np.ndarray  # (P, E_ext) int32, ext-local, receiver-sorted
    edge_mask: np.ndarray  # (P, E_ext) bool
    mef: np.ndarray        # (P, E_ext, D+1) mesh edge features
    rows: np.ndarray       # (P, N_ext+1) int32 CSR over ext receivers
    halo_size: int         # H
    n_ext: int             # extended rows (128-multiple, >= real + 1)
    depth: int             # ghost-zone depth
    rounds: int            # processor rounds per exchange (k)
    # telescoped stages after the first ``stage0_rounds`` rounds (None: one table)
    stages: Optional[List[TelescopeStage]] = None
    stage0_rounds: int = 0


def deep_depth(rounds: int, mps: int) -> int:
    """Ghost-zone depth sustaining exactness for ``rounds``-round segments."""
    return rounds if rounds >= mps else 2 * rounds - 1


def global_ids(pt: PartitionedTemplate, n: int) -> np.ndarray:
    """Original node id -> padded global id (``part * N_p + local slot``)."""
    counts = pt.node_mask.sum(1)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    pos = pt.perm[:n]
    part = np.searchsorted(offsets, pos, side="right") - 1
    return part * pt.part_nodes + (pos - offsets[part])


def add_deep_halo_plan(pt: PartitionedTemplate, mesh_pos: np.ndarray, senders: np.ndarray,
                       receivers: np.ndarray, rounds: int, mps: int, halo_multiple: int = 8,
                       chunk: int = 512, force_halo_size: Optional[int] = None,
                       force_edge_bucket: Optional[int] = None,
                       force_n_ext: Optional[int] = None,
                       telescope: Optional[Sequence[int]] = None) -> DeepHaloPlan:
    """Build the k-deep ghost-zone plan from the global edge list.

    ``pt`` fixes the part assignment and ordering; ``senders``/``receivers``
    are the original 0-based global edge list and ``mesh_pos`` the original
    positions (the deep edge table holds halo-region edges that no per-part
    table holds).  ``rounds`` must divide ``mps``.  ``chunk`` rounds the
    edge capacity up (the JAX package's kernel chunk; kept so the tables are
    its bits).  A forced capacity smaller than required raises
    ``ValueError``.  ``telescope``: the rounds of each stage, positive and
    summing to ``rounds`` (e.g. ``(5, 5, 5)``): the first stage runs on the
    extended table, each later one on its :class:`TelescopeStage`.  The
    arrays are those of ``mgn_tpu``'s ``add_deep_halo_plan(build_fused=False)``.
    """
    if mps % rounds != 0:
        raise ValueError(f"rounds {rounds} must divide mps {mps}")
    depth = deep_depth(rounds, mps)
    P, n_p = pt.num_parts, pt.part_nodes
    mesh_pos = np.asarray(mesh_pos, np.float32)
    senders = np.asarray(senders, np.int64).reshape(-1)
    receivers = np.asarray(receivers, np.int64).reshape(-1)
    n = mesh_pos.shape[0]

    counts = pt.node_mask.sum(1)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    pos = pt.perm[:n]
    part_of = (np.searchsorted(offsets, pos, side="right") - 1).astype(np.int64)
    local_of = pos - offsets[part_of]
    gid = part_of * n_p + local_of

    # distance to each part's owned set, capped at ``depth`` (multi-source BFS)
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    big = np.iinfo(np.int32).max // 2
    dist = np.full((P, n), big, np.int32)
    adj = csr_matrix((np.ones(len(senders), np.int8), (senders, receivers)), shape=(n, n))
    for p in range(P):
        d = dijkstra(adj, unweighted=True, min_only=True,
                     indices=np.nonzero(part_of == p)[0], limit=depth)
        dist[p] = np.where(np.isfinite(d), d, big).astype(np.int32)

    # serve lists: every remote node within distance ``depth``
    requests = [[np.zeros(0, np.int64) for _ in range(P)] for _ in range(P)]
    for p in range(P):
        ids = np.nonzero((dist[p] <= depth) & (part_of != p))[0]
        for q in range(P):
            if q != p:
                requests[p][q] = np.sort(local_of[ids[part_of[ids] == q]])
    h = max((len(requests[p][q]) for p in range(P) for q in range(P)), default=0)
    h = max(halo_multiple, int(-(-h // halo_multiple) * halo_multiple))
    if force_halo_size is not None:
        if force_halo_size < h:
            raise ValueError(f"forced deep halo size {force_halo_size} < required {h}")
        h = force_halo_size
    serve, serve_mask = _serve_tables(requests, P, h)

    # extended node tables: all own slots (pads included) + halo reals, by gid
    ext_gids, ext_edges = [], []
    mef_all = relative_mesh_features(mesh_pos, senders, receivers)
    for p in range(P):
        own = p * n_p + np.arange(n_p, dtype=np.int64)
        halo = gid[(dist[p] <= depth) & (part_of != p)]
        ext_gids.append(np.sort(np.concatenate([own, halo])))
        ext_edges.append(np.nonzero(dist[p][receivers] <= depth - 1)[0])
    n_ext = max(len(g) for g in ext_gids) + 1
    n_ext = int(-(-n_ext // 128) * 128)
    if force_n_ext is not None:
        if force_n_ext < n_ext:
            raise ValueError(f"forced n_ext {force_n_ext} < required {n_ext}")
        n_ext = force_n_ext
    e_ext = max(len(e) for e in ext_edges)
    e_ext = max(chunk, int(-(-e_ext // chunk) * chunk))
    if force_edge_bucket is not None:
        if force_edge_bucket < e_ext:
            raise ValueError(f"forced deep edge bucket {force_edge_bucket} < required {e_ext}")
        e_ext = force_edge_bucket

    src = np.full((P, n_ext), n_p + P * h, np.int32)  # pad rows -> the zero row
    own_pos = np.zeros((P, n_p), np.int32)
    s_ext = np.full((P, e_ext), n_ext - 1, np.int32)
    r_ext = np.full((P, e_ext), n_ext - 1, np.int32)
    emask = np.zeros((P, e_ext), bool)
    mef = np.zeros((P, e_ext, mef_all.shape[1]), np.float32)
    rows = np.zeros((P, n_ext + 1), np.int32)
    sorted_eids = []  # each part's receiver-sorted original edge ids (the stages')
    for p in range(P):
        g = ext_gids[p]
        k = len(g)
        owner = g // n_p
        loc = g % n_p
        sidx = np.empty(k, np.int64)
        own = owner == p
        sidx[own] = loc[own]
        for q in range(P):
            sel = owner == q
            if q != p and sel.any():
                sidx[sel] = n_p + q * h + np.searchsorted(requests[p][q], loc[sel])
        src[p, :k] = sidx.astype(np.int32)
        own_pos[p] = np.searchsorted(g, p * n_p + np.arange(n_p)).astype(np.int32)

        eid = ext_edges[p]
        rl = np.searchsorted(g, gid[receivers[eid]])
        o = np.argsort(rl, kind="stable")
        eid, rl = eid[o], rl[o]
        sorted_eids.append(eid)
        m = len(eid)
        s_ext[p, :m] = np.searchsorted(g, gid[senders[eid]]).astype(np.int32)
        r_ext[p, :m] = rl.astype(np.int32)
        # dead edges point at the first pad row (k, this part's real ext count)
        s_ext[p, m:] = k
        r_ext[p, m:] = k
        emask[p, :m] = True
        mef[p, :m] = mef_all[eid]
        rows[p, :n_ext] = csr_row_offsets(rl, n_ext - 1)
        rows[p, n_ext] = e_ext

    plan = DeepHaloPlan(src=src, own_pos=own_pos, serve=serve, serve_mask=serve_mask,
                        senders=s_ext, receivers=r_ext, edge_mask=emask, mef=mef, rows=rows,
                        halo_size=h, n_ext=n_ext, depth=depth, rounds=rounds)
    if telescope is None:
        return plan
    telescope = tuple(int(t) for t in telescope)
    if sum(telescope) != rounds or any(t <= 0 for t in telescope):
        raise ValueError(f"telescope {telescope} must be positive and sum to rounds {rounds}")
    stages = _telescope_stages(telescope, depth, dist, part_of, gid, senders, receivers,
                               ext_gids, sorted_eids, e_ext, n_p, chunk)
    return dataclasses.replace(plan, stages=stages, stage0_rounds=telescope[0])


def _telescope_stages(telescope, depth, dist, part_of, gid, senders, receivers, ext_gids,
                      sorted_eids, e_ext, n_p, chunk) -> List[TelescopeStage]:
    """The stages after the first of ``add_deep_halo_plan(telescope=)``."""
    P = len(ext_gids)
    pos0 = []  # each original edge's slot in part p's stage-0 edge table (e_ext: none)
    for p in range(P):
        slot = np.full(len(senders), e_ext, np.int64)
        slot[sorted_eids[p]] = np.arange(len(sorted_eids[p]))
        pos0.append(slot)
    stages, prev_gids, a = [], ext_gids, telescope[0]
    for t_rounds in telescope[1:]:
        d_s = depth - a
        per = []
        for p in range(P):
            own = p * n_p + np.arange(n_p, dtype=np.int64)
            ids = np.nonzero((dist[p] <= d_s) & (part_of != p))[0]
            g_s = np.sort(np.concatenate([own, gid[ids]]))
            eid = np.nonzero(dist[p][receivers] <= d_s - 1)[0]
            rl = np.searchsorted(g_s, gid[receivers[eid]])
            o = np.argsort(rl, kind="stable")
            per.append((g_s, eid[o], rl[o]))
        n_ext_s = int(-(-(max(len(g) for g, _, _ in per) + 1) // 128) * 128)
        e_ext_s = max(chunk, int(-(-max(len(e) for _, e, _ in per) // chunk) * chunk))
        nre = np.zeros((P, n_ext_s), np.int32)
        ere = np.full((P, e_ext_s), e_ext, np.int32)
        opos = np.zeros((P, n_p), np.int32)
        s_s = np.full((P, e_ext_s), n_ext_s - 1, np.int32)
        r_s = np.full((P, e_ext_s), n_ext_s - 1, np.int32)
        em_s = np.zeros((P, e_ext_s), bool)
        rows_s = np.zeros((P, n_ext_s + 1), np.int32)
        for p in range(P):
            g_s, eid, rl = per[p]
            k, m = len(g_s), len(eid)
            nre[p, :k] = np.searchsorted(prev_gids[p], g_s)
            nre[p, k:] = len(prev_gids[p])  # pad rows read the previous table's first pad row
            opos[p] = np.searchsorted(g_s, p * n_p + np.arange(n_p)).astype(np.int32)
            s_s[p, :m] = np.searchsorted(g_s, gid[senders[eid]])
            r_s[p, :m] = rl
            s_s[p, m:] = k  # dead edges: this part's first pad row, as in the main table
            r_s[p, m:] = k
            em_s[p, :m] = True
            ere[p, :m] = pos0[p][eid]
            rows_s[p, :n_ext_s] = csr_row_offsets(rl, n_ext_s - 1)
            rows_s[p, n_ext_s] = e_ext_s
        stages.append(TelescopeStage(rounds=t_rounds, depth=d_s, nremap=nre, eremap=ere,
                                     own_pos=opos, senders=s_s, receivers=r_s, edge_mask=em_s,
                                     rows=rows_s, n_ext=n_ext_s))
        prev_gids = [g for g, _, _ in per]
        a += t_rounds
    return stages


class KernelTables(NamedTuple):
    """One part's edge table as the processor's kernels take it
    (:func:`mgn_tpu_torch.ops.fused.fused_process`): int32 indices into a
    node table of ``rows`` rows."""

    senders: torch.Tensor         # (E,) int32
    receivers: torch.Tensor       # (E,) int32, nondecreasing
    row_offsets: torch.Tensor     # (rows+1,) int32 CSR over ``receivers``' order
    sender_perm: torch.Tensor     # (E,) int32 edge ids in stable sender order
    sender_offsets: torch.Tensor  # (rows+1,) int32
    edge_mask: torch.Tensor       # (E,) bool
    rows: int


def kernel_tables(senders: np.ndarray, receivers: np.ndarray, row_offsets: np.ndarray,
                  edge_mask: np.ndarray, rows: int, device) -> KernelTables:
    """Check one part's edge table against the kernels' invariants and build
    its tensors, sender-side CSR included (the processor's backward sums by
    sender through it), on ``device``.

    Invariants (``ValueError`` where one fails): every index lies in
    ``[0, rows)``; the receivers are nondecreasing; ``row_offsets`` has
    ``rows + 1`` nondecreasing entries from 0 to the edge count; each real
    edge (``edge_mask``) lies in its receiver's CSR row; each dead edge lies
    in the CSR row of a row no real edge sends from or into (a pad row), so
    its message, which ``edge_mask`` zeroes, reaches no real node."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    ro = np.asarray(row_offsets, np.int64)
    m = np.asarray(edge_mask, bool)
    e = len(s)
    if len(r) != e or len(m) != e or ro.shape != (rows + 1,):
        raise ValueError(f"edge table shapes: senders {s.shape}, receivers {r.shape}, "
                         f"mask {m.shape}, row_offsets {ro.shape} for {rows} rows")
    if e and (min(s.min(), r.min()) < 0 or max(s.max(), r.max()) >= rows):
        raise ValueError(f"edge indices outside the {rows}-row table")
    if np.any(np.diff(r) < 0):
        raise ValueError("receivers are not sorted")
    if ro[0] != 0 or ro[-1] != e or np.any(np.diff(ro) < 0):
        raise ValueError("row_offsets are not a CSR over the edges")
    row_of = np.repeat(np.arange(rows), np.diff(ro))
    if np.any(row_of[m] != r[m]):
        raise ValueError("a real edge lies outside its receiver's CSR row")
    used = np.zeros(rows, bool)
    used[s[m]] = used[r[m]] = True
    if np.any(used[row_of[~m]]):
        raise ValueError("a dead edge lies in the CSR row of a node that real edges use")
    perm, offsets = sender_csr(s.astype(np.int32), rows)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return KernelTables(t(s.astype(np.int32)), t(r.astype(np.int32)), t(ro.astype(np.int32)),
                        t(perm), t(offsets), t(m), rows)
