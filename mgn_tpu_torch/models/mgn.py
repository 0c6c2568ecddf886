"""Encode-Process-Decode MeshGraphNet: the port's ``mgn_tpu/models/mgn.py``.

- node and edge encoder MLPs into a shared latent size,
- ``message_passing_steps`` processor rounds: edge update
  ``f(e, v_sender, v_receiver)``, sum of the updated edge messages into the
  receivers, node update ``g(v, aggregate)``, residuals on both,
- decoder MLP (no LayerNorm) emitting the stacked target channels.

Layout as in the JAX package: node-major ``(N, F)``, processor parameters
stacked on a leading ``(mps,)`` axis, weights ``w (in, out)``.  On a CUDA
device the processor runs through the hand-written kernels of
:func:`mgn_tpu_torch.ops.fused.fused_process`; on the CPU through its plain
reference ``process_rounds_plain``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from mgn_tpu_torch._device import resolve_device, tree_to
from mgn_tpu_torch.core.graph import MeshGraph
from mgn_tpu_torch.models.mlp import apply_mlp, init_mlp
from mgn_tpu_torch.ops.fused import fused_process

__all__ = ["MGNConfig", "init_mgn", "apply_mgn"]


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    """Static model hyperparameters.  The TPU-only fields
    (``aggregation_backend``, ``unroll``, ``gather_backend``,
    ``sender_band``, ``receiver_band``, ``fused``, ``fused_backward``) are
    accepted so configs carry over, and have no effect."""

    node_input_dim: int
    edge_input_dim: int
    output_dim: int
    latent_size: int = 128
    hidden_layers: int = 2
    message_passing_steps: int = 15
    compute_dtype: torch.dtype = torch.float32
    aggregation_backend: Optional[str] = None
    unroll: bool = False
    gather_backend: str = "take"
    sender_band: int = 512
    receiver_band: int = 256
    fused: bool = False
    fused_backward: bool = False


def _stack(trees):
    """Stack matching nested dicts/lists of tensors on a new leading axis
    (the per-round processor parameters on ``(mps,)``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def init_mgn(cfg: MGNConfig, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Dict[str, Any]:
    """All model parameters as a nested dict of f32 tensors (Glorot-uniform
    weights drawn on the CPU from ``generator``, zero biases), on ``device``
    (``None``: the GPU, raising without one; pass ``"cpu"`` for the CPU)."""
    L, H = cfg.latent_size, cfg.hidden_layers
    params: Dict[str, Any] = {
        "node_encoder": init_mlp(cfg.node_input_dim, L, H, L, True, generator),
        "edge_encoder": init_mlp(cfg.edge_input_dim, L, H, L, True, generator),
        "decoder": init_mlp(L, L, H, cfg.output_dim, False, generator),
    }
    blocks = [{"edge_mlp": init_mlp(3 * L, L, H, L, True, generator),
               "node_mlp": init_mlp(2 * L, L, H, L, True, generator)}
              for _ in range(cfg.message_passing_steps)]
    params["processor"] = _stack(blocks)
    return tree_to(params, resolve_device(device))


def apply_mgn(params: Dict[str, Any], graph: MeshGraph, cfg: MGNConfig,
              row_offsets: torch.Tensor, sender_perm: Optional[torch.Tensor] = None,
              sender_offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward pass.  Returns per-node outputs ``(N_pad, output_dim)`` f32.

    ``row_offsets`` are the template's CSR offsets (the segment-sum kernel
    reduces over them); ``sender_perm``/``sender_offsets`` its sender-side
    CSR, which the processor's backward sums over (needed only where a
    gradient is)."""
    dt = cfg.compute_dtype
    edge_valid = graph.edge_mask.to(dt)[:, None]
    v = apply_mlp(params["node_encoder"], graph.node_features, dt)  # (N, L)
    e = apply_mlp(params["edge_encoder"], graph.edge_features, dt)  # (E, L)
    e = e * edge_valid
    v = fused_process(params["processor"], v, e, graph.senders, graph.receivers,
                      row_offsets, edge_valid, cfg.message_passing_steps,
                      sender_perm=sender_perm, sender_offsets=sender_offsets)
    return apply_mlp(params["decoder"], v, dt).float()
