"""The MLP arithmetic the model and the processor kernels' plain versions
share: :func:`apply_mlp_parts` and its pieces, under the dtype rules of
:mod:`mgn_tpu_torch.models.mlp` (which re-exports them).  It lives under
``ops`` and imports ``torch`` alone, so that the operator library
(:mod:`mgn_tpu_torch.ops.library`), and with it a loaded serving artefact,
needs nothing of ``models``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

__all__ = ["apply_mlp_parts", "layer_norm", "to_dtype"]


def to_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``: ``x`` itself where it is already, as
    ``Tensor.to`` returns it, but with no call at all, which a trace
    (``torch.export``) would record and an artefact would run."""
    return x if x.dtype == dtype else x.to(dtype)


def _dot(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``compute_dtype`` and the
    products accumulated in f32 (JAX's ``preferred_element_type=f32``)."""
    f32 = torch.float32
    return torch.matmul(to_dtype(to_dtype(x, compute_dtype), f32),
                        to_dtype(to_dtype(w, compute_dtype), f32))


def layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               width: Optional[int] = None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, eps 1e-5; the
    result has ``h``'s dtype.  ``width``: the real width of an ``h`` padded
    to a kernel's tile (``ops/fused.fused_process``): the statistics run
    over the first ``width`` columns, divided by ``width``, and the
    normalized value is 0 in the padded ones (so is the output, where the
    padded ``scale`` and ``bias`` are 0, as padding makes them).  None, or
    the whole width: the unpadded LayerNorm."""
    h32 = to_dtype(h, torch.float32)
    if width is not None and width != h.shape[-1]:
        x = h32[..., :width]
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        xhat = torch.nn.functional.pad((x - mean) * torch.rsqrt(var + 1e-5),
                                       (0, h.shape[-1] - width))
        return to_dtype(xhat * scale + bias, h.dtype)
    mean = h32.mean(dim=-1, keepdim=True)
    var = (h32 - mean).square().mean(dim=-1, keepdim=True)
    h32 = (h32 - mean) * torch.rsqrt(var + 1e-5)
    return to_dtype(h32 * scale + bias, h.dtype)


def apply_mlp_parts(
    params: Dict[str, Any], parts: Sequence[torch.Tensor],
    compute_dtype: torch.dtype = torch.float32,
    extra: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
) -> torch.Tensor:
    """Forward pass on a conceptual ``cat(parts, -1)`` input without
    materializing the concatenation: the first-layer weight is sliced per
    part and the contributions summed.  ``extra``: optional f32
    pre-activation offset added before the first bias.  ``width``: the
    LayerNorm's real width (:func:`layer_norm`)."""
    w0 = params["w"][0]
    h = None if extra is None else to_dtype(extra, torch.float32)
    off = 0
    for p in parts:
        d = p.shape[-1]
        contrib = _dot(p, w0[off: off + d], compute_dtype)
        h = contrib if h is None else h + contrib
        off += d
    if off != w0.shape[0]:
        raise ValueError(f"parts cover {off} input features, the weight has {w0.shape[0]}")
    h = to_dtype(h, compute_dtype) + to_dtype(params["b"][0], compute_dtype)
    for i in range(1, len(params["w"])):
        h = torch.relu(h)
        h = (to_dtype(_dot(h, params["w"][i], compute_dtype), compute_dtype)
             + to_dtype(params["b"][i], compute_dtype))
    if "ln_scale" in params:
        h = layer_norm(h, params["ln_scale"], params["ln_bias"], width)
    return h
