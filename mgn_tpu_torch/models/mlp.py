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
from typing import Any, Dict, Optional, Sequence

import torch

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


def _dot(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``compute_dtype`` and the
    products accumulated in f32 (JAX's ``preferred_element_type=f32``)."""
    return torch.matmul(x.to(compute_dtype).float(), w.to(compute_dtype).float())


def layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, eps 1e-5; the
    result has ``h``'s dtype."""
    h32 = h.float()
    mean = h32.mean(dim=-1, keepdim=True)
    var = (h32 - mean).square().mean(dim=-1, keepdim=True)
    h32 = (h32 - mean) * torch.rsqrt(var + 1e-5)
    return (h32 * scale + bias).to(h.dtype)


def apply_mlp_parts(
    params: Dict[str, Any], parts: Sequence[torch.Tensor],
    compute_dtype: torch.dtype = torch.float32,
    extra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward pass on a conceptual ``cat(parts, -1)`` input without
    materializing the concatenation: the first-layer weight is sliced per
    part and the contributions summed.  ``extra``: optional f32
    pre-activation offset added before the first bias."""
    w0 = params["w"][0]
    h = None if extra is None else extra.float()
    off = 0
    for p in parts:
        d = p.shape[-1]
        contrib = _dot(p, w0[off: off + d], compute_dtype)
        h = contrib if h is None else h + contrib
        off += d
    if off != w0.shape[0]:
        raise ValueError(f"parts cover {off} input features, the weight has {w0.shape[0]}")
    h = h.to(compute_dtype) + params["b"][0].to(compute_dtype)
    for i in range(1, len(params["w"])):
        h = torch.relu(h)
        h = (_dot(h, params["w"][i], compute_dtype).to(compute_dtype)
             + params["b"][i].to(compute_dtype))
    if "ln_scale" in params:
        h = layer_norm(h, params["ln_scale"], params["ln_bias"])
    return h


def apply_mlp(
    params: Dict[str, Any], x: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Forward pass; matmuls in ``compute_dtype`` with f32 accumulation,
    LayerNorm statistics in f32."""
    h = x.to(compute_dtype)
    n = len(params["w"])
    for i in range(n):
        h = (_dot(h, params["w"][i], compute_dtype).to(compute_dtype)
             + params["b"][i].to(compute_dtype))
        if i < n - 1:
            h = torch.relu(h)
    if "ln_scale" in params:
        h = layer_norm(h, params["ln_scale"], params["ln_bias"]).to(compute_dtype)
    return h
