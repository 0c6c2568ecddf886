"""CSR segment-sum: kernel K1 and its plain PyTorch version.

The counterpart of ``mgn_tpu/ops/pallas_segment.py``.  ``data (E_pad, F)``
holds receiver-sorted edge rows, ``row_offsets (N_pad+1,)`` their CSR
offsets; the result ``(N_pad, F)`` is always f32, whatever ``data``'s dtype
(f32 or bf16), as on the TPU.

:func:`csr_segment_sum` launches the CUDA kernel (``csrc/csr_segment.cu``)
for a CUDA tensor and runs :func:`csr_segment_sum_plain` for a CPU tensor;
any other device raises.  Its gradient is the row gather ``g[receivers]`` —
the TPU package's backward is a plain ``jnp.take`` too, not a kernel.
"""

from __future__ import annotations

import torch

from mgn_tpu_torch.ops import _build

__all__ = ["csr_segment_sum", "csr_segment_sum_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def csr_segment_sum_plain(data: torch.Tensor, receivers: torch.Tensor,
                          row_offsets: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version: f32 ``index_add_`` over the receivers (the ids that
    ``row_offsets`` describe)."""
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    return out.index_add_(0, receivers, data.float())


def _launch(data: torch.Tensor, row_offsets: torch.Tensor, num_segments: int) -> torch.Tensor:
    if data.dtype not in _DTYPE_CODES:
        raise TypeError(f"csr_segment_sum kernel takes f32 or bf16 data, got {data.dtype}")
    if data.dim() != 2 or data.shape[1] % 4 or data.shape[0] == 0:
        raise ValueError(f"data must be (E>0, F) with F a multiple of 4, got {tuple(data.shape)}")
    if row_offsets.dtype != torch.int32 or row_offsets.shape != (num_segments + 1,):
        raise ValueError(f"row_offsets must be int32 ({num_segments + 1},), got "
                         f"{row_offsets.dtype} {tuple(row_offsets.shape)}")
    if not (data.is_contiguous() and row_offsets.is_contiguous()):
        raise ValueError("csr_segment_sum kernel takes contiguous tensors")
    if row_offsets.device != data.device or data.data_ptr() % 16:
        raise ValueError("row_offsets must share data's device; data must be 16-byte aligned")
    out = torch.empty((num_segments, data.shape[1]), dtype=torch.float32, device=data.device)
    lib = _build.library("csr_segment")
    rc = lib.mgn_csr_segment_sum(
        data.data_ptr(), _DTYPE_CODES[data.dtype], row_offsets.data_ptr(), out.data_ptr(),
        num_segments, data.shape[1], torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(lib, rc, "csr_segment_sum")
    csr_segment_sum.launches += 1
    return out


class _CsrSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, receivers, row_offsets, num_segments):
        ctx.save_for_backward(receivers)
        ctx.data_dtype = data.dtype
        return _launch(data, row_offsets, num_segments)

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        return g.index_select(0, receivers).to(ctx.data_dtype), None, None, None


def csr_segment_sum(data: torch.Tensor, receivers: torch.Tensor,
                    row_offsets: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment-sum of receiver-sorted ``data`` (E_pad, F) into f32 (N_pad, F).

    CUDA tensor: kernel K1 (counted in ``csr_segment_sum.launches``).  CPU
    tensor: the plain version.
    """
    if data.device.type == "cpu":
        return csr_segment_sum_plain(data, receivers, row_offsets, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"csr_segment_sum runs on cuda or cpu, not {data.device}")
    return _CsrSegmentSum.apply(data, receivers, row_offsets, num_segments)


csr_segment_sum.launches = 0
