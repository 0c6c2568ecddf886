"""Graph-parallel Encode-Process-Decode forward: the port's
``mgn_tpu/parallel/halo.py``.

Each rank holds one part of the mesh (:mod:`mgn_tpu_torch.parallel.partition`):
its nodes, and the edges whose receiver it owns.  The processor's rounds run
through the single-device kernels (:func:`mgn_tpu_torch.ops.fused.fused_process`,
``return_edges=True``) over a node table that adds the rows the part's
edges read from other parts, which the ranks exchange:

- **deep** (:func:`apply_mgn_sharded_deep`, the default, ``halo_rounds =
  mps``): one exchange per ``rounds`` rounds.  Each segment builds ``[own;
  received; zero row]``, gathers the extended table through ``src`` and
  runs the segment's rounds in one ``fused_process`` call; for ``rounds ==
  mps`` that is the single-device kernel path per part plus one exchange.
  With telescoped stages (``add_deep_halo_plan(telescope=)``) the segment's
  first ``stage0_rounds`` rounds run on the extended table and each later
  stage's rounds on its nested, smaller table, one call a stage.
- **classic** (:func:`apply_mgn_sharded` with a serve plan, ``halo_rounds =
  0``): every round exchanges the boundary rows and runs one
  ``fused_process(mps=1)`` call over ``[own; received]``.
- **all-gather** (:func:`apply_mgn_sharded` without one): every round
  gathers every part's rows and runs one call over the whole table.

The exchanges are ``torch.autograd.Function``s.  :func:`halo_exchange`
gathers the served rows and sends them with one ``all_to_all_single``;
its backward sends the received rows' cotangents back the same way and sums
them into the served rows through K1's permutation path (a row served to
several parts gets one sum, in a fixed order: two backward passes give the
same bits; :class:`ServePlan` holds the serve table's CSR, built once on the
host).  :func:`all_gather_rows` gathers with ``all_gather_into_tensor``;
its backward is a reduce-scatter sum (each part's chunks through
``all_to_all_single``, added in rank order).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mgn_tpu_torch.models.mgn import MGNConfig
from mgn_tpu_torch.models.mlp import apply_mlp
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum
from mgn_tpu_torch.ops.fused import fused_process
from mgn_tpu_torch.parallel.mesh import Comm
from mgn_tpu_torch.parallel.partition import KernelTables, PartitionedTemplate, kernel_tables

__all__ = ["ServePlan", "DeepStage", "ShardGraph", "serve_plan", "shard_graph", "halo_exchange",
           "all_gather_rows", "apply_mgn_sharded", "apply_mgn_sharded_deep", "apply_shard",
           "EXCHANGES"]

EXCHANGES = ("deep", "halo", "gather")


class ServePlan(NamedTuple):
    """The rows one part sends each other part, and their CSR for the
    backward's sum: ``serve`` (P*H,) int32 local rows (row block ``q`` goes
    to part ``q``); ``perm``/``offsets`` the served entries in a stable
    order by row and that order's offsets over the part's ``rows`` rows
    (padded entries in no row)."""

    serve: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    rows: int


def serve_plan(serve: np.ndarray, serve_mask: np.ndarray, rows: int, device) -> ServePlan:
    """One part's :class:`ServePlan` from its ``(P, H)`` serve table and mask."""
    s = np.asarray(serve, np.int64).reshape(-1)
    key = np.where(np.asarray(serve_mask).reshape(-1), s, rows)
    perm = np.argsort(key, kind="stable")
    offsets = np.searchsorted(key[perm], np.arange(rows + 1))
    t = lambda a: torch.as_tensor(a.astype(np.int32)).to(device)  # noqa: E731
    return ServePlan(t(s), t(perm), t(offsets), rows)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, plan: ServePlan, comm: Comm):
        ctx.plan, ctx.comm = plan, comm
        return comm.all_to_all(v.index_select(0, plan.serve))

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        back = ctx.comm.all_to_all(g)
        dv = csr_segment_sum(back, plan.serve, plan.offsets, plan.rows, perm=plan.perm)
        return dv.to(g.dtype), None, None


def _differentiable(v: torch.Tensor) -> bool:
    """Whether an exchange of ``v`` needs its ``autograd.Function``: serving
    (no gradient, or a traced program) calls the forward's body directly."""
    return torch.is_grad_enabled() and v.requires_grad


def halo_exchange(v: torch.Tensor, plan: ServePlan, comm: Comm) -> torch.Tensor:
    """The rows this part's edges read from the other parts: ``(P*H, L)``,
    row block ``q`` from part ``q``.  Differentiable in ``v``."""
    if not _differentiable(v):
        return comm.all_to_all(v.index_select(0, plan.serve))
    return _HaloExchange.apply(v, plan, comm)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, comm: Comm):
        ctx.comm = comm
        return comm.all_gather(v)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        parts = comm.all_to_all(g).view(comm.size, -1, g.shape[1])
        total = parts[0].float()
        for q in range(1, comm.size):
            total = total + parts[q].float()
        return total.to(g.dtype), None


def all_gather_rows(v: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Every part's rows, stacked in part order (differentiable in ``v``)."""
    if not _differentiable(v):
        return comm.all_gather(v)
    return _AllGather.apply(v, comm)


class DeepStage(NamedTuple):
    """One telescope stage of a part on its rank's device: its rounds, its
    node rows in the previous stage's table (``nremap``), the stage-0 edge
    slots of its real edges (``eremap``, which lead its edge table; the pad
    slots after them start from zero and are not written back), the owned
    rows' positions and its edge table."""

    rounds: int
    nremap: torch.Tensor   # (n_ext_s,) int64
    eremap: torch.Tensor   # (real edges,) int64
    own_pos: torch.Tensor  # (N_p,) int64
    tables: KernelTables


def _deep_stage(st, p: int, e_ext: int, device) -> DeepStage:
    """Part ``p`` of a :class:`~mgn_tpu_torch.parallel.partition.TelescopeStage`
    on ``device``; the pad slots of its edge remap are checked to follow its
    real ones and to point one past the stage-0 table."""
    m = int(st.edge_mask[p].sum())
    ere = np.asarray(st.eremap[p], np.int64)
    if not (st.edge_mask[p][:m].all() and (ere[:m] < e_ext).all() and (ere[m:] == e_ext).all()):
        raise ValueError("a telescope stage's real edges must lead its table and map into "
                         "the stage-0 edges, its pad slots one past them")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int64)).to(device)  # noqa: E731
    return DeepStage(st.rounds, t(st.nremap[p]), t(ere[:m]), t(st.own_pos[p]),
                     kernel_tables(st.senders[p], st.receivers[p], st.rows[p], st.edge_mask[p],
                                   st.n_ext, device))


@dataclasses.dataclass
class ShardGraph:
    """One part of a partitioned template on its rank's device, with the
    tables its exchange needs (:func:`shard_graph`).

    ``mef``/``edge_mask`` are the part's own edges (each real edge of the
    mesh in exactly one part: the edge normalizer accumulates over them);
    ``fwd_mef`` and ``tables`` the forward's edge table (the deep plan's
    extended edges, or the part's own)."""

    exchange: str
    node_type_onehot: torch.Tensor  # (N_p, T)
    node_type: torch.Tensor  # (N_p,) int32, -1 on pads
    node_mask: torch.Tensor  # (N_p,) bool
    mef: torch.Tensor  # (E_p, D+1)
    edge_mask: torch.Tensor  # (E_p,) bool
    fwd_mef: torch.Tensor  # (E_fwd, D+1)
    tables: KernelTables
    serve: Optional[ServePlan] = None
    src: Optional[torch.Tensor] = None  # deep: (N_ext,) into [own; recv; zero row]
    own_pos: Optional[torch.Tensor] = None  # deep: (N_p,)
    rounds: int = 1
    stages: Optional[List[DeepStage]] = None  # deep, telescoped
    stage0_rounds: int = 0

    @property
    def nbytes(self) -> int:
        ts = [self.node_type_onehot, self.node_type, self.node_mask, self.mef, self.edge_mask,
              self.fwd_mef, *self.tables[:6], *(self.serve[:3] if self.serve else ()),
              self.src, self.own_pos]
        for st in self.stages or ():
            ts += [st.nremap, st.eremap, st.own_pos, *st.tables[:6]]
        return sum(t.numel() * t.element_size() for t in ts if t is not None)


def shard_graph(pt: PartitionedTemplate, part: int, exchange: str, device) -> ShardGraph:
    """Part ``part`` of ``pt`` as its rank's :class:`ShardGraph` for the
    ``exchange`` form (``"deep"``: ``pt.deep``; ``"halo"``: the classic plan;
    ``"gather"``: no plan), its edge tables checked against the kernels'
    invariants (:func:`~mgn_tpu_torch.parallel.partition.kernel_tables`)."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, got {exchange!r}")
    p, n_p, P = part, pt.part_nodes, pt.num_parts
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)  # noqa: E731
    common = dict(exchange=exchange, node_type_onehot=t(pt.node_type_onehot[p]),
                  node_type=t(pt.node_type[p]), node_mask=t(pt.node_mask[p]),
                  mef=t(pt.mesh_edge_features[p]), edge_mask=t(pt.edge_mask[p]))
    e_p = pt.senders_global.shape[1]
    if exchange == "deep":
        d = pt.deep
        if d is None:
            raise ValueError("the deep exchange needs a template with a deep plan "
                             "(add_deep_halo_plan)")
        _check_gather(d.src[p], n_p + P * d.halo_size + 1, n_p + P * d.halo_size)
        tables = kernel_tables(d.senders[p], d.receivers[p], d.rows[p], d.edge_mask[p],
                               d.n_ext, device)
        stages = (None if d.stages is None else
                  [_deep_stage(st, p, d.senders.shape[1], device) for st in d.stages])
        return ShardGraph(**common, fwd_mef=t(d.mef[p]), tables=tables,
                          serve=serve_plan(d.serve[p], d.serve_mask[p], n_p, device),
                          src=t(d.src[p].astype(np.int64)),
                          own_pos=t(d.own_pos[p].astype(np.int64)), rounds=d.rounds,
                          stages=stages, stage0_rounds=d.stage0_rounds)
    if exchange == "halo":
        if pt.senders_halo is None:
            raise ValueError("the halo exchange needs a template with a halo plan "
                             "(add_halo_plan)")
        rows = n_p + P * pt.halo_size
        offsets = np.full(rows + 1, e_p, np.int32)
        offsets[: n_p + 1] = pt.row_offsets[p]
        tables = kernel_tables(pt.senders_halo[p], pt.receivers_local[p], offsets,
                               pt.edge_mask[p], rows, device)
        return ShardGraph(**common, fwd_mef=common["mef"], tables=tables,
                          serve=serve_plan(pt.halo_serve[p], pt.halo_serve_mask[p], n_p, device))
    # all-gather: the table is every part's rows, this part's receivers offset into it
    rows = P * n_p
    offsets = np.concatenate([np.zeros(p * n_p, np.int32), pt.row_offsets[p],
                              np.full((P - 1 - p) * n_p, e_p, np.int32)])
    tables = kernel_tables(pt.senders_global[p], pt.receivers_local[p] + p * n_p, offsets,
                           pt.edge_mask[p], rows, device)
    return ShardGraph(**common, fwd_mef=common["mef"], tables=tables)


def _check_gather(src: np.ndarray, rows: int, zero_row: int) -> None:
    """The deep table's gather maps each own and received row at most once
    (only the zero row repeats), so its backward, an ``index_add_``, adds
    at most one cotangent into any row that matters."""
    s = np.asarray(src, np.int64)
    if s.min() < 0 or s.max() >= rows:
        raise ValueError("deep src indexes outside [own; received; zero row]")
    real = s[s != zero_row]
    if len(np.unique(real)) != len(real):
        raise ValueError("deep src maps an own or received row twice")


def _rounds(proc: Dict[str, Any], a: int, b: int) -> Dict[str, Any]:
    """Rounds ``[a, b)`` of processor parameters stacked on ``(mps,)``."""
    if isinstance(proc, dict):
        return {k: _rounds(v, a, b) for k, v in proc.items()}
    if isinstance(proc, list):
        return [_rounds(v, a, b) for v in proc]
    return proc[a:b]


def _process(proc, x, e, tables: KernelTables, edge_valid, rounds: int):
    return fused_process(proc, x, e, tables.senders, tables.receivers, tables.row_offsets,
                         edge_valid, rounds, return_edges=True,
                         sender_perm=tables.sender_perm, sender_offsets=tables.sender_offsets)


def apply_mgn_sharded(params: Dict[str, Any], node_features: torch.Tensor,
                      edge_features: torch.Tensor, cfg: MGNConfig, comm: Comm,
                      tables: KernelTables, serve: Optional[ServePlan] = None) -> torch.Tensor:
    """One part's forward with one exchange a round; returns its decoded
    rows ``(N_p, output_dim)`` f32.

    ``node_features`` ``(N_p, F_n)`` are the part's own rows,
    ``edge_features`` ``(E_p, F_e)`` its edges' normalized features.  With
    ``serve`` (the classic halo): each round exchanges the boundary rows and
    runs one ``fused_process(mps=1)`` over ``[own; received]``, ``tables``
    indexing that table (:func:`shard_graph` ``"halo"``).  Without: each
    round gathers every part's rows and runs over the whole table
    (``"gather"``)."""
    dt = cfg.compute_dtype
    n_p = node_features.shape[0]
    edge_valid = tables.edge_mask.to(dt)[:, None]
    v = apply_mlp(params["node_encoder"], node_features, dt)
    e = apply_mlp(params["edge_encoder"], edge_features, dt) * edge_valid
    proc = params["processor"]
    for r in range(cfg.message_passing_steps):
        if serve is not None:
            x = torch.cat([v, halo_exchange(v, serve, comm)])
            x, e = _process(_rounds(proc, r, r + 1), x, e, tables, edge_valid, 1)
            v = x[:n_p]
        else:
            x, e = _process(_rounds(proc, r, r + 1), all_gather_rows(v, comm), e, tables,
                            edge_valid, 1)
            v = x[comm.rank * n_p:(comm.rank + 1) * n_p]
    return apply_mlp(params["decoder"], v, dt).float()


def apply_mgn_sharded_deep(params: Dict[str, Any], node_features: torch.Tensor,
                           ext_edge_features: torch.Tensor, cfg: MGNConfig, comm: Comm,
                           tables: KernelTables, serve: ServePlan, src: torch.Tensor,
                           own_pos: torch.Tensor, rounds: int,
                           stages: Optional[Sequence[DeepStage]] = None,
                           stage0_rounds: int = 0) -> torch.Tensor:
    """One part's k-deep ghost-zone forward (``partition.DeepHaloPlan``):
    one exchange per ``rounds`` rounds, each segment one ``fused_process``
    call over the extended tables.  Owned rows are exact by the ghost-zone
    argument.  ``ext_edge_features`` are the extended edge table's
    normalized features; returns ``(N_p, output_dim)`` f32.

    ``stages`` (telescoped): each segment runs its first ``stage0_rounds``
    rounds over the extended table, then each stage gathers its node rows
    through ``nremap`` and its edge latents from the stage-0 buffer through
    ``eremap`` (its pad slots zero), runs its rounds in one call over its
    own tables and writes its real edge latents back into a new stage-0
    buffer; the owned rows come from the last stage's ``own_pos``."""
    mps = cfg.message_passing_steps
    if mps % rounds:
        raise ValueError(f"rounds {rounds} must divide mps {mps}")
    stages = stages or ()
    first = stage0_rounds if stages else rounds
    if first + sum(st.rounds for st in stages) != rounds:
        raise ValueError(f"the stages' rounds must sum to rounds {rounds}")
    dt = cfg.compute_dtype
    edge_valid = tables.edge_mask.to(dt)[:, None]
    v = apply_mlp(params["node_encoder"], node_features, dt)
    e = apply_mlp(params["edge_encoder"], ext_edge_features, dt) * edge_valid
    proc = params["processor"]
    for a in range(0, mps, rounds):
        recv = halo_exchange(v, serve, comm)
        table = torch.cat([v, recv, v.new_zeros((1, v.shape[1]))])
        x = table.index_select(0, src)
        x, e = _process(_rounds(proc, a, a + first), x, e, tables, edge_valid, first)
        b, own = a + first, own_pos
        for st in stages:
            x = x.index_select(0, st.nremap)
            m = st.eremap.shape[0]
            e_s = torch.cat([e.index_select(0, st.eremap),
                             e.new_zeros((st.tables.senders.shape[0] - m, e.shape[1]))])
            x, e_s = _process(_rounds(proc, b, b + st.rounds), x, e_s, st.tables,
                              st.tables.edge_mask.to(dt)[:, None], st.rounds)
            e = e.index_copy(0, st.eremap, e_s[:m])
            b, own = b + st.rounds, st.own_pos
        v = x.index_select(0, own)
    return apply_mlp(params["decoder"], v, dt).float()


def apply_shard(params: Dict[str, Any], node_features: torch.Tensor, norm_edge,
                shard: ShardGraph, cfg: MGNConfig, comm: Comm) -> torch.Tensor:
    """The forward of ``shard``'s exchange form: its forward edge table's
    features normalized by ``norm_edge`` and masked, then
    :func:`apply_mgn_sharded_deep` or :func:`apply_mgn_sharded`."""
    ef = norm_edge(shard.fwd_mef) * shard.tables.edge_mask[:, None]
    if shard.exchange == "deep":
        return apply_mgn_sharded_deep(params, node_features, ef, cfg, comm, shard.tables,
                                      shard.serve, shard.src, shard.own_pos, shard.rounds,
                                      shard.stages, shard.stage0_rounds)
    return apply_mgn_sharded(params, node_features, ef, cfg, comm, shard.tables, shard.serve)
