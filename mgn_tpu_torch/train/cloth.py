"""Cloth / world-space dynamics family (FlagSimple-class models): the
port's ``mgn_tpu/train/cloth.py``, serving half.

3-D world-space dynamics on a 2-D reference mesh, with world edges rebuilt
by a radius query at every step beside the mesh edges, and second-order
(acceleration) targets integrated semi-implicitly:

    vel_in   = (x_t - x_{t-1}) / dt
    acc_pred = MGN(vel_in, onehot; mesh edges [u_ij, |u_ij|, x_ij, |x_ij|],
                   world edges [x_ij, |x_ij|])
    x_{t+1}  = 2 x_t - x_{t-1} + acc_pred * dt^2

Handle nodes (types outside ``types_updated``) are forced from the drive
(the ground truth) at every step.  The trainer (``make_cloth_trainer``)
comes with cloth training, the port's next slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import GraphTemplate, build_world_edges
from mgn_tpu_torch.models.mgn_multi import EdgeSet, MultiGraph, MultiMGNConfig, apply_mgn_multi
from mgn_tpu_torch.train.common import NormState, type_mask

__all__ = ["ClothConfig", "cloth_model_config", "make_cloth_norm_state", "build_cloth_graph",
           "make_cloth_rollout"]


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


def build_cloth_graph(norm: NormState, template: GraphTemplate, world_pos: torch.Tensor,
                      vel: torch.Tensor, cfg: ClothConfig) -> MultiGraph:
    """The two-edge-set graph at one state, normalized, with the world
    edges built here from ``world_pos`` (mesh pairs excluded)."""
    node_mask = template.node_mask
    nf = torch.cat([norm.node["velocity"](vel),
                    norm.node["node_type"](template.node_type_onehot)], -1)
    nf = nf * node_mask[:, None]

    rel_w = world_pos[template.senders] - world_pos[template.receivers]
    mesh_feat = torch.cat([template.mesh_edge_features, rel_w,
                           torch.linalg.vector_norm(rel_w, dim=-1, keepdim=True)], -1)
    mesh_feat = norm.edge["mesh"](mesh_feat) * template.edge_mask[:, None]

    ws, wr, wm = build_world_edges(world_pos, node_mask, cfg.world_radius, cfg.world_capacity,
                                   exclude_senders=template.senders,
                                   exclude_receivers=template.receivers)
    rel_ww = (world_pos[ws] - world_pos[wr]) * wm[:, None]
    world_feat = torch.cat([rel_ww, torch.linalg.vector_norm(rel_ww, dim=-1, keepdim=True)], -1)
    world_feat = norm.edge["world"](world_feat) * wm[:, None]

    return MultiGraph(
        node_features=nf,
        edge_sets=(EdgeSet(features=mesh_feat, senders=template.senders,
                           receivers=template.receivers, mask=template.edge_mask,
                           row_offsets=template.row_offsets),
                   EdgeSet(features=world_feat, senders=ws, receivers=wr, mask=wm)),
        node_mask=node_mask,
    )


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
