"""Encode-Process-Decode with two edge sets (mesh edges + world edges):
the port's ``mgn_tpu/models/mgn_multi.py``, for the cloth / contact family
(FlagSimple).

- one encoder MLP per edge set,
- per processor round: a per-set edge update ``f_k(e_k, v_s, v_r)``, a sum
  of each set's messages into the receivers, and one node update
  ``g(v, agg_mesh, agg_world)``; residuals everywhere,
- the decoder MLP (no LayerNorm).

The round math is that of the JAX package's fused branch
(``mgn_multi.py:141-183``, what the TPU runs by default; it too takes
exactly two sets), on every device.  The mesh set and the node stage go
through :func:`mgn_tpu_torch.ops.fused.fused_process` (K2 -> K1 -> K3 a
round on a CUDA device, their plain versions on the CPU) with the node MLP's
first layer cut to its ``[v | agg_mesh]`` rows.  The world set, rebuilt
every step into a fixed-capacity buffer, runs in plain PyTorch inside
``fused_process``'s per-round ``node_extra`` hook: gathers, the edge MLP
(``torch.matmul``; XLA computes it outside any Pallas kernel too), the mask,
an f32 segment sum (K1 through a receiver permutation made once a forward:
world edges come sorted by sender), and the aggregate's first-layer term
``agg @ W0[2L:3L]`` in f32 from the f32 master weights, which K3 adds into
the node MLP's pre-activation.  ``fused_process`` carries the mesh latents
across the rounds; the hook carries the world latents (``e_w + msg_w``).

Where a gradient is needed the rounds take the JAX fused branch's structure
itself (``fblock``, ``mgn_multi.py:151``): per round the world set in plain
PyTorch autograd, then one differentiable ``fused_process(mps=1,
return_edges=True, node_extra=<the offset>)``, whose backward returns the
offset's cotangent from K5 (``dxtr``); the world set's parameters get their
gradient through it.  The world set's row gathers sum their cotangents
through K1 and the ids' CSR order (``gather_ordered``), as the mesh set's
sender side does, so two backward passes give the same bits.  The mesh set
then needs the template's sender-side CSR (``EdgeSet.sender_perm``,
``sender_offsets``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from mgn_tpu_torch._device import resolve_device, tree_to
from mgn_tpu_torch.models.mgn import _stack
from mgn_tpu_torch.models.mlp import apply_mlp, init_mlp
from mgn_tpu_torch.ops.fused import fused_process, round_params
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum
from mgn_tpu_torch.ops.segment import csr_order, gather, gather_ordered

__all__ = ["EdgeSet", "MultiGraph", "MultiMGNConfig", "init_mgn_multi", "apply_mgn_multi"]


@dataclasses.dataclass
class EdgeSet:
    features: torch.Tensor  # (E_k, F_k)
    senders: torch.Tensor  # (E_k,) int32
    receivers: torch.Tensor  # (E_k,) int32
    mask: torch.Tensor  # (E_k,) bool
    row_offsets: Optional[torch.Tensor] = None  # CSR offsets: the mesh set's only
    # the mesh set's sender-side CSR (the template's), which its backward sums over
    sender_perm: Optional[torch.Tensor] = None
    sender_offsets: Optional[torch.Tensor] = None


@dataclasses.dataclass
class MultiGraph:
    node_features: torch.Tensor  # (N, F_n)
    edge_sets: Tuple[EdgeSet, ...]  # (receiver-sorted mesh edges, world edges)
    node_mask: torch.Tensor  # (N,) bool


@dataclasses.dataclass(frozen=True)
class MultiMGNConfig:
    """Static hyperparameters.  The TPU-only fields
    (``aggregation_backend``, ``fused``, ``fused_backward``) are accepted so
    configs carry over, and have no effect: every set is summed by K1."""

    node_input_dim: int
    edge_input_dims: Tuple[int, ...]  # one per edge set
    output_dim: int
    latent_size: int = 128
    hidden_layers: int = 2
    message_passing_steps: int = 15
    compute_dtype: torch.dtype = torch.float32
    aggregation_backend: Optional[str] = None
    fused: bool = False
    fused_backward: bool = False

    @property
    def num_edge_sets(self) -> int:
        return len(self.edge_input_dims)


def init_mgn_multi(cfg: MultiMGNConfig, generator: Optional[torch.Generator] = None,
                   device: Optional[torch.device] = None) -> Dict[str, Any]:
    """All parameters as a nested dict of f32 tensors in the JAX package's
    layout (``edge_encoders`` and the processor's ``edge_mlps`` lists, one
    per edge set; the node MLP's first layer ``(K + 1) L`` rows), drawn on
    the CPU from ``generator``, on ``device`` (``None``: the GPU)."""
    L, H, K = cfg.latent_size, cfg.hidden_layers, cfg.num_edge_sets
    params: Dict[str, Any] = {
        "node_encoder": init_mlp(cfg.node_input_dim, L, H, L, True, generator),
        "decoder": init_mlp(L, L, H, cfg.output_dim, False, generator),
        "edge_encoders": [init_mlp(d, L, H, L, True, generator) for d in cfg.edge_input_dims],
    }
    blocks = [{"edge_mlps": [init_mlp(3 * L, L, H, L, True, generator) for _ in range(K)],
               "node_mlp": init_mlp((K + 1) * L, L, H, L, True, generator)}
              for _ in range(cfg.message_passing_steps)]
    params["processor"] = _stack(blocks)
    return tree_to(params, resolve_device(device))


def apply_mgn_multi(params: Dict[str, Any], graph: MultiGraph,
                    cfg: MultiMGNConfig) -> torch.Tensor:
    """Forward pass -> ``(N, output_dim)`` f32.  The graph holds exactly two
    edge sets, as the JAX fused branch does: set 0, the mesh edges, with its
    CSR ``row_offsets`` (the template's), and set 1, the world edges, in any
    order and without ``row_offsets``.  Where a gradient is needed, set 0
    also carries the template's ``sender_perm`` and ``sender_offsets``."""
    dt, L = cfg.compute_dtype, cfg.latent_size
    if cfg.num_edge_sets != 2 or len(graph.edge_sets) != 2:
        raise ValueError(f"apply_mgn_multi takes a mesh set and a world set; the config has "
                         f"{cfg.num_edge_sets} edge sets, the graph {len(graph.edge_sets)}")
    mesh, world = graph.edge_sets
    if mesh.row_offsets is None:
        raise ValueError("edge set 0 (the mesh edges) needs its CSR row_offsets")
    if world.row_offsets is not None:
        raise ValueError("edge set 1 (the world edges) is summed through its own receiver "
                         "order and takes no row_offsets")
    n = graph.node_features.shape[0]
    proc = params["processor"]
    v = apply_mlp(params["node_encoder"], graph.node_features, dt)
    e_mesh, e_world = (apply_mlp(params["edge_encoders"][k], s.features, dt)
                       * s.mask.to(dt)[:, None] for k, s in enumerate(graph.edge_sets))
    w0n = proc["node_mlp"]["w"][0]  # (mps, 3 L, L): rows [v | agg_mesh | agg_world]
    node_mesh = dict(proc["node_mlp"], w=[w0n[:, :2 * L]] + list(proc["node_mlp"]["w"][1:]))
    wmask = world.mask.to(dt)[:, None]
    mesh_valid = mesh.mask.to(dt)[:, None]
    # the world set's receiver order, made once for every round; its dead
    # slots sort after every row, so K1 reads only the live messages
    perm, offsets = csr_order(world.receivers, n, world.mask)
    leaves = [t for m in (*proc["edge_mlps"], proc["node_mlp"]) for t in _leaves(m)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (v, e_mesh, e_world, *leaves)):
        v = _rounds_with_grad(proc, node_mesh, v, e_mesh, e_world, mesh, mesh_valid, world,
                              wmask, (perm, offsets), cfg)
        return apply_mlp(params["decoder"], v, dt).float()
    carry = [e_world]

    def world_set(r: int, v_r: torch.Tensor) -> torch.Tensor:
        """Round ``r`` of the world set: its messages, f32 aggregate and the
        aggregate's first-layer term (K3's offset)."""
        mlp = round_params(proc["edge_mlps"][1], r)
        msg = apply_mlp(mlp, torch.cat([carry[0], gather(v_r, world.senders),
                                        gather(v_r, world.receivers)], -1), dt) * wmask
        agg = csr_segment_sum(msg, world.receivers, offsets, n, perm=perm)
        carry[0] = carry[0] + msg
        return torch.matmul(agg, w0n[r, 2 * L:].float())

    v = fused_process({"edge_mlp": proc["edge_mlps"][0], "node_mlp": node_mesh}, v, e_mesh,
                      mesh.senders, mesh.receivers, mesh.row_offsets, mesh_valid,
                      cfg.message_passing_steps, node_extra=world_set)
    return apply_mlp(params["decoder"], v, dt).float()


def _leaves(mlp: Dict[str, Any]):
    return [*mlp["w"], *mlp["b"], mlp["ln_scale"], mlp["ln_bias"]]


def _one_round(mlp: Dict[str, Any], r: int) -> Dict[str, Any]:
    """Round ``r`` of a processor MLP stacked on ``(mps,)``, as a one-round stack."""
    return {k: [x[r:r + 1] for x in val] if isinstance(val, list) else val[r:r + 1]
            for k, val in mlp.items()}


def _rounds_with_grad(proc, node_mesh, v, e_mesh, e_world, mesh: EdgeSet, mesh_valid,
                      world: EdgeSet, wmask, receiver_order, cfg: MultiMGNConfig):
    """The processor rounds where a gradient is needed, round by round as
    the JAX fused branch runs them (``fblock``): the world set's messages,
    f32 aggregate and first-layer offset in plain PyTorch autograd, then one
    differentiable ``fused_process(mps=1)`` of the mesh set and the node
    stage with that offset.  Returns the final ``v``."""
    dt, L, n = cfg.compute_dtype, cfg.latent_size, v.shape[0]
    perm, offsets = receiver_order
    sender_order = csr_order(world.senders, n, world.mask)  # once a forward, as the receivers'
    w0n = proc["node_mlp"]["w"][0]
    e_m, e_w = e_mesh, e_world
    for r in range(cfg.message_passing_steps):
        vs = gather_ordered(v, world.senders, *sender_order)
        vr = gather_ordered(v, world.receivers, perm, offsets)
        msg_w = apply_mlp(round_params(proc["edge_mlps"][1], r),
                          torch.cat([e_w, vs, vr], -1), dt) * wmask
        agg_w = csr_segment_sum(msg_w, world.receivers, offsets, n, perm=perm)
        extra = torch.matmul(agg_w, w0n[r, 2 * L:].float())
        v, e_m = fused_process(
            {"edge_mlp": _one_round(proc["edge_mlps"][0], r),
             "node_mlp": _one_round(node_mesh, r)}, v, e_m, mesh.senders, mesh.receivers,
            mesh.row_offsets, mesh_valid, 1, return_edges=True, sender_perm=mesh.sender_perm,
            sender_offsets=mesh.sender_offsets, node_extra=extra)
        e_w = e_w + msg_w
    return v
