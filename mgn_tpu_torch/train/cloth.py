"""Cloth / world-space dynamics family (FlagSimple-class models): the
port's ``mgn_tpu/train/cloth.py``.

3-D world-space dynamics on a 2-D reference mesh, with world edges rebuilt
by a radius query at every step beside the mesh edges, and second-order
(acceleration) targets integrated semi-implicitly:

    vel_in   = (x_t - x_{t-1}) / dt
    acc_pred = MGN(vel_in, onehot; mesh edges [u_ij, |u_ij|, x_ij, |x_ij|],
                   world edges [x_ij, |x_ij|])
    x_{t+1}  = 2 x_t - x_{t-1} + acc_pred * dt^2

Handle nodes (types outside ``types_updated``) are forced from the drive
(the ground truth) at every step.  The training target is the
finite-difference acceleration of the ground truth with input noise on
``x_t``, online-normalized like every other quantity
(:func:`make_cloth_trainer`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import GraphTemplate, build_world_edges
from mgn_tpu_torch.models.mgn_multi import EdgeSet, MultiGraph, MultiMGNConfig, apply_mgn_multi
from mgn_tpu_torch.train.common import NormState, TrainState, masked_mse, type_mask

__all__ = ["ClothConfig", "cloth_model_config", "make_cloth_norm_state", "cloth_world_edges",
           "build_cloth_graph", "make_cloth_trainer", "make_cloth_rollout"]

WorldEdges = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (senders, receivers, mask)


@dataclasses.dataclass(frozen=True)
class ClothConfig:
    model: MultiMGNConfig
    world_radius: float = 0.05
    world_capacity: int = 512  # fixed world-edge buffer size
    noise_stddev: float = 0.003
    types_updated: Tuple[int, ...] = (0,)
    types_noisy: Tuple[int, ...] = (0,)
    norm_steps: int = 1000
    world_dim: int = 3


def cloth_model_config(meta: Dict[str, Any], latent: int = 128, hidden_layers: int = 2,
                       mps: int = 15, **kw) -> MultiMGNConfig:
    """The two-edge-set model of a cloth meta.json (``flag_meta``): node
    inputs velocity + one-hot type, mesh edges ``[u_ij, |u_ij|, x_ij,
    |x_ij|]``, world edges ``[x_ij, |x_ij|]``, acceleration out."""
    wd = int(meta.get("world_dim", 3))
    md = 2  # reference mesh space
    t_depth = (int(meta["features"]["node_type"]["data_max"])
               - int(meta["features"]["node_type"]["data_min"]) + 1)
    return MultiMGNConfig(node_input_dim=wd + t_depth, edge_input_dims=(md + 1 + wd + 1, wd + 1),
                          output_dim=wd, latent_size=latent, hidden_layers=hidden_layers,
                          message_passing_steps=mps, **kw)


def make_cloth_norm_state(cfg: ClothConfig, max_acc: float = 1e7) -> NormState:
    md, wd = 2, cfg.world_dim
    return NormState(
        edge={"mesh": N.Online.create(md + 1 + wd + 1, max_acc),
              "world": N.Online.create(wd + 1, max_acc)},
        node={"velocity": N.Online.create(wd, max_acc),
              "node_type": N.OfflineMinMax.create(0.0, 1.0)},
        output={"acceleration": N.Online.create(wd, max_acc)},
    )


def cloth_world_edges(template: GraphTemplate, world_pos: torch.Tensor,
                      cfg: ClothConfig) -> WorldEdges:
    """The radius query at one state: world edges of ``world_pos``, the
    mesh pairs excluded, in a ``cfg.world_capacity`` buffer."""
    return build_world_edges(world_pos, template.node_mask, cfg.world_radius,
                             cfg.world_capacity, exclude_senders=template.senders,
                             exclude_receivers=template.receivers)


def _raw_edge_feats(template: GraphTemplate, world_pos: torch.Tensor) -> torch.Tensor:
    """The mesh edges' raw features ``[u_ij, |u_ij|, x_ij, |x_ij|]``."""
    rel_w = world_pos[template.senders] - world_pos[template.receivers]
    return torch.cat([template.mesh_edge_features, rel_w,
                      torch.linalg.vector_norm(rel_w, dim=-1, keepdim=True)], -1)


def _raw_world_feats(world_pos: torch.Tensor, world_edges: WorldEdges) -> torch.Tensor:
    """The world edges' raw features ``[x_ij, |x_ij|]`` (zeros in empty slots)."""
    ws, wr, wm = world_edges
    rel_ww = (world_pos[ws] - world_pos[wr]) * wm[:, None]
    return torch.cat([rel_ww, torch.linalg.vector_norm(rel_ww, dim=-1, keepdim=True)], -1)


def build_cloth_graph(norm: NormState, template: GraphTemplate, world_pos: torch.Tensor,
                      vel: torch.Tensor, cfg: ClothConfig,
                      world_edges: Optional[WorldEdges] = None) -> MultiGraph:
    """The two-edge-set graph at one state, normalized.  ``world_edges``:
    ``(senders, receivers, mask)`` of this state, where the caller has
    built them (the trainer does, for the normalizers); otherwise the radius
    query runs here (mesh pairs excluded)."""
    node_mask = template.node_mask
    nf = torch.cat([norm.node["velocity"](vel),
                    norm.node["node_type"](template.node_type_onehot)], -1)
    nf = nf * node_mask[:, None]
    mesh_feat = norm.edge["mesh"](_raw_edge_feats(template, world_pos))
    mesh_feat = mesh_feat * template.edge_mask[:, None]
    if world_edges is None:
        world_edges = cloth_world_edges(template, world_pos, cfg)
    ws, wr, wm = world_edges
    world_feat = norm.edge["world"](_raw_world_feats(world_pos, world_edges)) * wm[:, None]

    return MultiGraph(
        node_features=nf,
        edge_sets=(EdgeSet(features=mesh_feat, senders=template.senders,
                           receivers=template.receivers, mask=template.edge_mask,
                           row_offsets=template.row_offsets,
                           sender_perm=template.sender_perm,
                           sender_offsets=template.sender_offsets),
                   EdgeSet(features=world_feat, senders=ws, receivers=wr, mask=wm)),
        node_mask=node_mask,
    )


def make_cloth_trainer(cfg: ClothConfig) -> Callable:
    """Build ``train_window(state, template, world_pos (T, N_pad, 3), times
    (T,), perm, generator) -> (state, losses)``: the port's
    ``make_cloth_trainer`` of ``mgn_tpu/train/cloth.py``, a Python loop over
    the sampled frames ``t`` in ``[1, T-1)`` (``perm``).  Per frame, in the
    JAX order: noise ``noise_stddev * N(0, 1)`` (from ``generator``, a
    ``torch.Generator`` on the training device) on ``x_t`` at the
    ``types_noisy`` nodes; velocity ``(x_t - x_{t-1}) / dt`` and acceleration
    ``(x_{t+1} - 2 x_t + x_{t-1}) / dt^2``; Online accumulation of the
    velocity, the acceleration, the mesh edges' raw features and the world
    edges' ``[x_ij, |x_ij|]`` from this frame's radius query (built once and
    given to the graph); the normalized target; the masked MSE on the
    ``types_updated`` nodes.  The optimizer (``state.optimizer``, over
    ``param_leaves(state.params)``) steps only from step ``norm_steps`` on;
    a warm-up step runs the forward under ``torch.no_grad()``, which leaves
    parameters, optimizer state and loss as JAX's discarded update does
    (``train/derivative.py``).  ``state`` is updated in place and returned
    with the losses ``(len(perm),)`` f32 on the host."""

    def one_step(state: TrainState, template: GraphTemplate, world_pos: torch.Tensor,
                 times: torch.Tensor, t: int, gen: torch.Generator) -> torch.Tensor:
        node_mask = template.node_mask
        update_mask = type_mask(template.node_type, cfg.types_updated) & node_mask
        noisy_mask = type_mask(template.node_type, cfg.types_noisy) & node_mask
        with torch.no_grad():
            dt = times[t] - times[t - 1]
            prev, cur, nxt = world_pos[t - 1], world_pos[t], world_pos[t + 1]
            noise = cfg.noise_stddev * torch.randn(cur.shape, generator=gen, device=cur.device)
            cur = cur + noise * noisy_mask[:, None]
            vel = (cur - prev) / dt
            acc = (nxt - 2 * cur + prev) / (dt * dt)
            world_edges = cloth_world_edges(template, cur, cfg)
            norm = state.norm
            state.norm = NormState(
                edge={**norm.edge,
                      "mesh": N.accumulate(norm.edge["mesh"], _raw_edge_feats(template, cur),
                                           template.edge_mask),
                      "world": N.accumulate(norm.edge["world"],
                                            _raw_world_feats(cur, world_edges),
                                            world_edges[2])},
                node={**norm.node, "velocity": N.accumulate(norm.node["velocity"], vel,
                                                            node_mask)},
                output={**norm.output,
                        "acceleration": N.accumulate(norm.output["acceleration"], acc,
                                                     node_mask)})
            target = state.norm.output["acceleration"](acc)
            graph = build_cloth_graph(state.norm, template, cur, vel, cfg, world_edges)

        def loss_fn():
            return masked_mse(apply_mgn_multi(state.params, graph, cfg.model), target,
                              update_mask)

        if state.step >= cfg.norm_steps:
            state.optimizer.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            state.optimizer.step()
        else:
            with torch.no_grad():
                loss = loss_fn()
        state.step += 1
        return loss.detach()

    def train_window(state: TrainState, template: GraphTemplate, world_pos: torch.Tensor,
                     times: torch.Tensor, perm, generator: torch.Generator):
        losses = [one_step(state, template, world_pos, times, int(t), generator) for t in perm]
        return state, torch.stack(losses).float().cpu()

    return train_window


def make_cloth_rollout(cfg: ClothConfig) -> Callable:
    """Build ``rollout(params, norm, template, world_pos_gt (T, N, 3), times
    (T,)) -> pred (T, N, 3)``: the semi-implicit second-order integration
    from the first two frames, handle nodes forced from ``world_pos_gt``.
    The model runs on the tensors' device (kernels on CUDA, the plain path
    on the CPU); call it under ``torch.no_grad()``."""

    def rollout(params, norm: NormState, template: GraphTemplate,
                world_pos_gt: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        update = (type_mask(template.node_type, cfg.types_updated) & template.node_mask)[:, None]
        prev, cur = world_pos_gt[0], world_pos_gt[1]
        preds = [prev, cur]
        for t in range(1, world_pos_gt.shape[0] - 1):
            dt = times[t] - times[t - 1]
            vel = (cur - prev) / dt
            graph = build_cloth_graph(norm, template, cur, vel, cfg)
            acc = norm.output["acceleration"].inverse(apply_mgn_multi(params, graph, cfg.model))
            nxt = 2 * cur - prev + acc * dt * dt
            nxt = torch.where(update, nxt, world_pos_gt[t + 1])
            prev, cur = cur, nxt
            preds.append(nxt)
        return torch.stack(preds)

    return rollout
