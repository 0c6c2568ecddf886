"""Functional MLP building block: the port's ``mgn_tpu/models/mlp.py``.

Parameters are plain nested dicts with the JAX package's layout — ``w`` a
list of ``(in, out)`` matrices, ``b`` a list of ``(out,)`` vectors, optional
``ln_scale``/``ln_bias`` — so weights carry across unchanged
(:mod:`mgn_tpu_torch.convert`).

Dtype rules (identical to the JAX package):

- matmul inputs, weights included, are cast to the compute dtype and the
  products are accumulated in f32;
- the result is cast to the compute dtype before the bias, and the bias is
  cast to the compute dtype;
- LayerNorm statistics are f32, eps 1e-5.

These are the plain versions: the encoder and decoder use them on every
device (in JAX they are plain XLA too), and the processor uses them only on
the CPU — on the GPU it runs through the hand-written kernels of
:mod:`mgn_tpu_torch.ops.fused`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from mgn_tpu_torch.ops.mlp_math import _dot, apply_mlp_parts, layer_norm, to_dtype

__all__ = ["init_mlp", "apply_mlp", "apply_mlp_parts", "layer_norm"]


def init_mlp(
    in_dim: int,
    latent_size: int,
    hidden_layers: int,
    out_dim: int,
    layer_norm: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """``hidden_layers`` hidden layers + linear output; Glorot-uniform
    weights and zero biases (f32, CPU)."""
    dims = [in_dim] + [latent_size] * hidden_layers + [out_dim]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        limit = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        u = torch.rand((dims[i], dims[i + 1]), generator=generator, dtype=torch.float32)
        ws.append(u * (2 * limit) - limit)
        bs.append(torch.zeros((dims[i + 1],), dtype=torch.float32))
    params: Dict[str, Any] = {"w": ws, "b": bs}
    if layer_norm:
        params["ln_scale"] = torch.ones((out_dim,), dtype=torch.float32)
        params["ln_bias"] = torch.zeros((out_dim,), dtype=torch.float32)
    return params


def apply_mlp(
    params: Dict[str, Any], x: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Forward pass; matmuls in ``compute_dtype`` with f32 accumulation,
    LayerNorm statistics in f32."""
    h = to_dtype(x, compute_dtype)
    n = len(params["w"])
    for i in range(n):
        h = (to_dtype(_dot(h, params["w"][i], compute_dtype), compute_dtype)
             + to_dtype(params["b"][i], compute_dtype))
        if i < n - 1:
            h = torch.relu(h)
    if "ln_scale" in params:
        h = to_dtype(layer_norm(h, params["ln_scale"], params["ln_bias"]), compute_dtype)
    return h
