"""Graph-parallel cloth / world-edge family: the port's
``mgn_tpu/parallel/cloth.py``.

World edges are rebuilt every frame in world space and cross the parts
anywhere, so they take no static halo plan.  The schedule is the all-gather
one, sized to the family (cloth meshes are small: the flag's 1,664 padded
nodes gather 2 x 832 x 128 f32 rows, 0.85 MB, a round):

- each round all-gathers the node latents (``all_gather_rows``); the mesh
  set and the node stage run as one ``fused_process(mps=1, node_extra=...,
  return_edges=True)`` call over the gathered table, this part's receivers
  offset into it (the A7a ``"gather"`` form,
  :func:`~mgn_tpu_torch.parallel.halo.shard_graph`), K3 updating every row
  and only this part's rows kept; the world set's MLP runs in
  ``torch.matmul`` and its receiver sum through K1-perm, as on one device
  (:mod:`mgn_tpu_torch.models.mgn_multi`), its first-layer offset zero on
  the other parts' rows;
- world edges are built per part each frame (:func:`build_world_edges_sharded`):
  the part scans the ``(N_tot, N_p)`` block whose receivers it owns with the
  single-device builder's arithmetic, senders global;
- the normalizers accumulate with their new sums summed over the group
  (``accumulate_synced_all``), and the loss and the gradients are summed
  after ``backward()``.

Host side: the JAX module's ``partition_cloth`` is
:func:`~mgn_tpu_torch.parallel.partition.partition_template`, its
``unpermute_field_stack`` is
:func:`~mgn_tpu_torch.parallel.rollout.unpermute_sharded`, and its
``cloth_static_batch`` is the ``"gather"``
:class:`~mgn_tpu_torch.parallel.halo.ShardGraph`
(``shard_graph(pt, part, "gather", device)``: kernel tables over the
gathered ``(P * N_p)``-row table, senders global, receivers offset by
``part * N_p``, ``mef`` the reference-mesh edge features ``[u_ij,
|u_ij|]``); :func:`partition_field_stack` changes the layout.  Device
side: :func:`apply_cloth_sharded`, :func:`make_sharded_cloth_trainer` and
:func:`make_sharded_cloth_rollout`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import first_hits, within_radius, world_centre
from mgn_tpu_torch.models.mgn_multi import MultiMGNConfig, _one_round
from mgn_tpu_torch.models.mlp import apply_mlp
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum
from mgn_tpu_torch.ops.fused import fused_process, round_params
from mgn_tpu_torch.ops.mlp_math import to_dtype
from mgn_tpu_torch.ops.segment import csr_order, gather_ordered
from mgn_tpu_torch.parallel.halo import ShardGraph, all_gather_rows
from mgn_tpu_torch.parallel.mesh import Comm
from mgn_tpu_torch.parallel.partition import PartitionedTemplate
from mgn_tpu_torch.parallel.spmd import _sum_grads, partition_stack
from mgn_tpu_torch.train.cloth import ClothConfig
from mgn_tpu_torch.train.common import NormState, TrainState, param_leaves, type_mask

__all__ = ["partition_field_stack", "build_world_edges_sharded", "apply_cloth_sharded",
           "make_sharded_cloth_trainer", "make_sharded_cloth_rollout"]

WorldEdges = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (senders, receivers, mask)


# --- host side -------------------------------------------------------------------------------

def partition_field_stack(pt: PartitionedTemplate, arr: np.ndarray) -> np.ndarray:
    """``(T, N, dim)`` in the dataset's node order -> ``(T, P, N_p, dim)``
    padded parts, f32 (pads zero)."""
    return partition_stack(pt, arr).swapaxes(0, 1)


def _local_receivers(shard: ShardGraph, comm: Comm) -> torch.Tensor:
    return shard.tables.receivers - comm.rank * shard.node_mask.shape[0]


# --- device side -----------------------------------------------------------------------------

def build_world_edges_sharded(wp_local: torch.Tensor, mask_local: torch.Tensor, radius: float,
                              capacity: int, comm: Comm,
                              exclude_senders: Optional[torch.Tensor] = None,
                              exclude_receivers: Optional[torch.Tensor] = None,
                              wp_full: Optional[torch.Tensor] = None,
                              mask_full: Optional[torch.Tensor] = None) -> WorldEdges:
    """This part's world edges: ``core.graph.build_world_edges``'s
    semantics over the ``(N_tot, N_p)`` block whose receivers the part owns
    (the positions centred on the masked mean of the whole gathered table,
    summed in f64; the elementwise Gram distances; self pairs and the
    excluded mesh pairs, global senders and local receivers, removed), the
    first ``capacity`` hits kept by key ``s_global * N_p + r_local``.
    ``wp_full``/``mask_full``: the gathered table, where the caller has it.
    Returns ``(senders, receivers, mask)``, each ``(capacity,)``: senders
    index the gathered table ``[part 0; part 1; ...]``, receivers are
    local.  The union over the parts is the single-device set where no part
    and not the single device overflows its capacity."""
    n_p = wp_local.shape[0]
    if wp_full is None:
        wp_full = comm.all_gather(wp_local)
    if mask_full is None:
        mask_full = comm.all_gather(mask_local.to(torch.uint8))
    n_tot = wp_full.shape[0]
    if n_tot * n_p >= 2 ** 31:
        raise ValueError(f"world-edge ranking key overflows int32: N_tot * N_p = {n_tot} * "
                         f"{n_p} >= 2^31; shard the mesh further")
    mask_full, mask_local = mask_full.to(torch.bool), mask_local.to(torch.bool)
    hit = (within_radius(wp_full, wp_local, world_centre(wp_full, mask_full), radius)
           & mask_full[:, None] & mask_local[None, :])
    local = torch.arange(n_p, device=hit.device)
    hit[comm.rank * n_p + local, local] = False  # self pairs
    if exclude_senders is not None:
        hit[exclude_senders.long(), exclude_receivers.long()] = False
    return first_hits(hit, capacity)


def apply_cloth_sharded(params: Dict[str, Any], node_features: torch.Tensor,
                        mesh_ef: torch.Tensor, world_ef: torch.Tensor, shard: ShardGraph,
                        world: WorldEdges, cfg: MultiMGNConfig, comm: Comm) -> torch.Tensor:
    """One part's two-edge-set forward -> ``(N_p, output_dim)`` f32: the
    distributed twin of ``models.mgn_multi.apply_mgn_multi`` (the same round
    math).  ``node_features`` ``(N_p, F_n)``, ``mesh_ef`` ``(E_p, F_m)`` and
    ``world_ef`` ``(W, F_w)`` are normalized and masked; ``world`` is
    :func:`build_world_edges_sharded`'s.  Each round gathers every part's
    latents once (``all_gather_rows``); the world set reads its senders from
    that table and its receivers from this part's rows, and its f32
    aggregate's first-layer term enters K3 as ``node_extra``, zero on the
    other parts' rows; the mesh set and the node stage run as one
    ``fused_process(mps=1)`` call over the gathered table."""
    dt, L = cfg.compute_dtype, cfg.latent_size
    n_p = node_features.shape[0]
    tables = shard.tables
    ws, wr, wm = world
    proc = params["processor"]
    v = apply_mlp(params["node_encoder"], node_features, dt)
    mesh_valid = tables.edge_mask.to(dt)[:, None]
    wmask = wm.to(dt)[:, None]
    e_m = apply_mlp(params["edge_encoders"][0], mesh_ef, dt) * mesh_valid
    e_w = apply_mlp(params["edge_encoders"][1], world_ef, dt) * wmask
    w0n = proc["node_mlp"]["w"][0]  # (mps, 3 L, L): rows [v | agg_mesh | agg_world]
    node_mesh = dict(proc["node_mlp"], w=[w0n[:, :2 * L]] + list(proc["node_mlp"]["w"][1:]))
    # the world set's orders, made once a forward: receivers over this part's rows,
    # senders over the gathered table
    perm, offsets = csr_order(wr, n_p, wm)
    sender_order = csr_order(ws, tables.rows, wm)
    lo, hi = comm.rank * n_p, (comm.rank + 1) * n_p
    for r in range(cfg.message_passing_steps):
        v_full = all_gather_rows(v, comm)
        vs = gather_ordered(v_full, ws, *sender_order)
        vr = gather_ordered(v, wr, perm, offsets)
        msg_w = apply_mlp(round_params(proc["edge_mlps"][1], r),
                          torch.cat([e_w, vs, vr], -1), dt) * wmask
        agg_w = csr_segment_sum(msg_w, wr, offsets, n_p, perm=perm)
        extra = torch.matmul(agg_w, to_dtype(w0n[r, 2 * L:], torch.float32))
        extra = torch.cat([extra.new_zeros((lo, L)), extra,
                           extra.new_zeros((tables.rows - hi, L))])
        x, e_m = fused_process(
            {"edge_mlp": _one_round(proc["edge_mlps"][0], r),
             "node_mlp": _one_round(node_mesh, r)}, v_full, e_m, tables.senders,
            tables.receivers, tables.row_offsets, mesh_valid, 1, return_edges=True,
            sender_perm=tables.sender_perm, sender_offsets=tables.sender_offsets,
            node_extra=extra)
        v = x[lo:hi]
        e_w = e_w + msg_w
    return apply_mlp(params["decoder"], v, dt).float()


def _mask_full(shard: ShardGraph, comm: Comm) -> torch.Tensor:
    """Every part's node mask, in part order."""
    return comm.all_gather(shard.node_mask.to(torch.uint8)).to(torch.bool)


def _frame_features(shard: ShardGraph, cur: torch.Tensor, comm: Comm
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gathered positions and the part's mesh edges' raw features
    ``[u_ij, |u_ij|, x_ij, |x_ij|]``."""
    wp_full = all_gather_rows(cur, comm)
    rel = (wp_full.index_select(0, shard.tables.senders)
           - cur.index_select(0, _local_receivers(shard, comm)))
    raw = torch.cat([shard.mef, rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], -1)
    return wp_full, raw


def _world(shard: ShardGraph, cur: torch.Tensor, wp_full, mask_full, cfg: ClothConfig,
           capacity: int, comm: Comm) -> Tuple[WorldEdges, torch.Tensor]:
    """This frame's world edges of the part and their raw features ``[x_ij, |x_ij|]``."""
    world = build_world_edges_sharded(
        cur, shard.node_mask, cfg.world_radius, capacity, comm,
        exclude_senders=shard.tables.senders, exclude_receivers=_local_receivers(shard, comm),
        wp_full=wp_full, mask_full=mask_full)
    ws, wr, wm = world
    rel = (wp_full.index_select(0, ws) - cur.index_select(0, wr)) * wm[:, None]
    return world, torch.cat([rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], -1)


def _inputs(norm: NormState, shard: ShardGraph, vel, mesh_raw, world_raw, wm):
    nf = torch.cat([norm.node["velocity"](vel), norm.node["node_type"](shard.node_type_onehot)],
                   -1) * shard.node_mask[:, None]
    return (nf, norm.edge["mesh"](mesh_raw) * shard.edge_mask[:, None],
            norm.edge["world"](world_raw) * wm[:, None])


def make_sharded_cloth_trainer(comm: Comm, cfg: ClothConfig, capacity: int) -> Callable:
    """Build ``train_window(state, shard, world_pos (T, N_p, 3), times (T,),
    perm, generator) -> (state, losses)`` over the graph group ``comm``:
    ``train.cloth.make_cloth_trainer``'s window on this part (``shard`` from
    the ``"gather"`` ``ShardGraph``, ``world_pos`` its rows of the trajectory).  Per
    frame ``t`` of ``perm`` (in ``[1, T-1)``): noise on this part's
    ``types_noisy`` rows from ``generator``, velocity and acceleration, the
    gathered positions, the part's mesh features and world edges
    (``capacity`` per part), the synced accumulation of the velocity, the
    acceleration, the mesh and the world features; the masked MSE over the
    group's count of updated nodes; past ``norm_steps`` the gradient summed
    over the group and one optimizer step.  ``state`` is updated in place;
    ``losses`` ``(len(perm),)`` f32 on the host, summed over the group."""

    def one_step(state: TrainState, shard: ShardGraph, world_pos, times, t: int,
                 gen: torch.Generator, mask_full: torch.Tensor) -> torch.Tensor:
        node_mask = shard.node_mask
        update = (type_mask(shard.node_type, cfg.types_updated) & node_mask).float()
        noisy = type_mask(shard.node_type, cfg.types_noisy) & node_mask
        with torch.no_grad():
            dt = times[t] - times[t - 1]
            prev, cur, nxt = world_pos[t - 1], world_pos[t], world_pos[t + 1]
            noise = cfg.noise_stddev * torch.randn(cur.shape, generator=gen, device=cur.device)
            cur = cur + noise * noisy[:, None]
            vel = (cur - prev) / dt
            acc = (nxt - 2 * cur + prev) / (dt * dt)
            wp_full, mesh_raw = _frame_features(shard, cur, comm)
            world, world_raw = _world(shard, cur, wp_full, mask_full, cfg, capacity, comm)
            norm = state.norm
            v_n, a_n, m_n, w_n = N.accumulate_synced_all(
                [(norm.node["velocity"], vel, node_mask),
                 (norm.output["acceleration"], acc, node_mask),
                 (norm.edge["mesh"], mesh_raw, shard.edge_mask),
                 (norm.edge["world"], world_raw, world[2])], comm)
            state.norm = norm = NormState(edge={**norm.edge, "mesh": m_n, "world": w_n},
                                          node={**norm.node, "velocity": v_n},
                                          output={**norm.output, "acceleration": a_n})
            target = norm.output["acceleration"](acc)
            nf, mesh_ef, world_ef = _inputs(norm, shard, vel, mesh_raw, world_raw, world[2])
            count = comm.all_reduce(update.sum().reshape(1))

        def loss_fn() -> torch.Tensor:
            out = apply_cloth_sharded(state.params, nf, mesh_ef, world_ef, shard, world,
                                      cfg.model, comm)
            return (((out - target) ** 2).sum(-1) * update).sum() / torch.clamp(count[0], min=1.0)

        if state.step >= cfg.norm_steps:
            state.optimizer.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            _sum_grads(param_leaves(state.params), comm)
            state.optimizer.step()
        else:
            with torch.no_grad():
                loss = loss_fn()
        state.step += 1
        return comm.all_reduce(loss.detach().reshape(1).clone())[0]

    def train_window(state: TrainState, shard: ShardGraph, world_pos: torch.Tensor,
                     times: torch.Tensor, perm, generator: torch.Generator):
        mask_full = _mask_full(shard, comm)
        losses = [one_step(state, shard, world_pos, times, int(t), generator, mask_full)
                  for t in perm]
        return state, torch.stack(losses).float().cpu()

    return train_window


def make_sharded_cloth_rollout(comm: Comm, cfg: ClothConfig, capacity: int) -> Callable:
    """Build ``rollout(params, norm, shard, world_pos_gt (T, N_p, 3), times
    (T,)) -> pred (T, N_p, 3)``: ``train.cloth.make_cloth_rollout``'s
    semi-implicit integration of this part from the first two frames,
    handle nodes forced from ``world_pos_gt``, world edges rebuilt every
    step from the gathered positions (``capacity`` per part).  Call it under
    ``torch.no_grad()`` on every rank of ``comm``; gather the parts with
    ``parallel.rollout.gather_prediction`` and reorder them with
    ``parallel.rollout.unpermute_sharded``."""

    def rollout(params, norm: NormState, shard: ShardGraph, world_pos_gt: torch.Tensor,
                times: torch.Tensor) -> torch.Tensor:
        update = (type_mask(shard.node_type, cfg.types_updated) & shard.node_mask)[:, None]
        mask_full = _mask_full(shard, comm)
        prev, cur = world_pos_gt[0], world_pos_gt[1]
        preds = [prev, cur]
        for t in range(1, world_pos_gt.shape[0] - 1):
            dt = times[t] - times[t - 1]
            vel = (cur - prev) / dt
            wp_full, mesh_raw = _frame_features(shard, cur, comm)
            world, world_raw = _world(shard, cur, wp_full, mask_full, cfg, capacity, comm)
            nf, mesh_ef, world_ef = _inputs(norm, shard, vel, mesh_raw, world_raw, world[2])
            acc = norm.output["acceleration"].inverse(
                apply_cloth_sharded(params, nf, mesh_ef, world_ef, shard, world, cfg.model, comm))
            nxt = torch.where(update, 2 * cur - prev + acc * dt * dt, world_pos_gt[t + 1])
            prev, cur = cur, nxt
            preds.append(nxt)
        return torch.stack(preds)

    return rollout
