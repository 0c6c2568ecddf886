"""CSR segment-sum: kernel K1 and its plain PyTorch version.

The counterpart of ``mgn_tpu/ops/pallas_segment.py``.  ``data (E_pad, F)``
holds receiver-sorted edge rows, ``row_offsets (N_pad+1,)`` their CSR
offsets; the result ``(N_pad, F)`` is always f32, whatever ``data``'s dtype
(f32 or bf16), as on the TPU.  Rows outside ``[row_offsets[0],
row_offsets[-1])`` are in no segment and are never read.  With ``perm``
(int32 ``(E_pad,)``) row ``n`` sums ``data[perm[j]]`` for ``j`` in
``[row_offsets[n], row_offsets[n+1])``:
the processor's backward sums the sender-side cotangents through the
template's sender permutation (``GraphTemplate.sender_perm`` /
``sender_offsets``), so senders, which are not sorted, need no atomics either.

:func:`csr_segment_sum` calls the operator
``torch.ops.mgn_tpu_torch.csr_segment_sum`` (:mod:`mgn_tpu_torch.ops.library`),
which launches the CUDA kernel (``csrc/csr_segment.cu``) for a CUDA tensor
and runs :func:`csr_segment_sum_plain` for a CPU tensor; any other device
raises.  Its gradient is the row gather ``g[segment_ids]`` — the TPU
package's backward is a plain ``jnp.take`` too, not a kernel.

Both versions sum in one fixed order, so the kernel gives the plain
version's bits: row ``n``'s entries, in CSR order, are cut into chunks of
:data:`CHUNK` entries counted from the row's start; each chunk is summed
left to right from zero in f32 (bf16 widened first), and the row's value is
its chunk sums added left to right from zero.  A row of at most ``CHUNK``
entries (every real row of the cylinder's and the flag's templates) is
thus summed left to right; only longer rows, such as the trash row that
collects the padded dead edges, are summed chunk by chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from mgn_tpu_torch.ops import _build

__all__ = ["CHUNK", "csr_segment_sum", "csr_segment_sum_plain"]

# C of the fixed order: entries a chunk (the kernel's kChunk; it refuses any other)
CHUNK = 16

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def csr_segment_sum_plain(data: torch.Tensor, receivers: torch.Tensor,
                          row_offsets: Optional[torch.Tensor], num_segments: int,
                          perm: Optional[torch.Tensor] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version, in K1's fixed order (see the module's docstring): two
    f32 ``index_add_`` calls, the summed rows into chunk sums, then the chunk
    sums into rows.  On the CPU ``index_add_`` adds in index order, so each
    sum runs left to right from zero.  The summed rows are ``data[j]`` (or
    ``data[perm[j]]``) for ``j`` in ``[row_offsets[0], row_offsets[-1])``,
    row ``n`` taking ``[row_offsets[n], row_offsets[n+1])``; without
    ``row_offsets`` (identity form only) every row of ``data``, row ``e``
    in segment ``receivers[e]``, each segment's rows in their order.
    ``out``: an f32 ``(num_segments, F)`` buffer to overwrite and return."""
    dev = data.device
    if out is None:
        out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32, device=dev)
    else:
        out.zero_()
    if row_offsets is None:
        if perm is not None:
            raise ValueError("csr_segment_sum_plain: perm needs row_offsets")
        ids, rows = receivers.long(), data
        counts = torch.bincount(ids, minlength=num_segments)
        # each row's rank in its segment: its place among the segment's rows
        order = torch.argsort(ids, stable=True)
        rank = torch.empty_like(ids)
        rank[order] = (torch.arange(ids.numel(), device=dev)
                       - (torch.cumsum(counts, 0) - counts)[ids[order]])
    else:
        offsets = row_offsets.long()
        lo, hi = int(offsets[0]), int(offsets[-1])
        counts = torch.diff(offsets)
        ids = torch.repeat_interleave(torch.arange(num_segments, device=dev), counts)
        rank = torch.arange(lo, hi, device=dev) - offsets[ids]
        rows = data[lo:hi] if perm is None else data.index_select(0, perm[lo:hi])
    chunks = (counts + CHUNK - 1) // CHUNK
    first = torch.cumsum(chunks, 0) - chunks
    sums = torch.zeros((int(chunks.sum()), data.shape[1]), dtype=torch.float32, device=dev)
    sums.index_add_(0, first[ids] + rank // CHUNK, rows.float())
    return out.index_add_(0, torch.repeat_interleave(
        torch.arange(num_segments, device=dev), chunks), sums)


def _launch(data: torch.Tensor, row_offsets: torch.Tensor, num_segments: int,
            perm: Optional[torch.Tensor], out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's launch: the CUDA implementation of the ``csr_segment_sum``
    operators (:mod:`mgn_tpu_torch.ops.library`), into ``out`` or a new
    f32 ``(num_segments, F)`` tensor."""
    if data.dtype not in _DTYPE_CODES:
        raise TypeError(f"csr_segment_sum kernel takes f32 or bf16 data, got {data.dtype}")
    if data.dim() != 2 or data.shape[1] == 0 or data.shape[0] == 0:
        raise ValueError(f"data must be (E>0, F>0), got {tuple(data.shape)}")
    if row_offsets.dtype != torch.int32 or row_offsets.shape != (num_segments + 1,):
        raise ValueError(f"row_offsets must be int32 ({num_segments + 1},), got "
                         f"{row_offsets.dtype} {tuple(row_offsets.shape)}")
    if not (data.is_contiguous() and row_offsets.is_contiguous()):
        raise ValueError("csr_segment_sum kernel takes contiguous tensors")
    # rows of a multiple of 4 columns are read 16 bytes at a time (the tail
    # form of other widths value by value)
    if row_offsets.device != data.device or (data.shape[1] % 4 == 0 and data.data_ptr() % 16):
        raise ValueError("row_offsets must share data's device; data must be 16-byte aligned")
    if perm is not None and (perm.dtype != torch.int32 or perm.shape != (data.shape[0],)
                             or perm.device != data.device or not perm.is_contiguous()):
        raise ValueError(f"perm must be a contiguous int32 ({data.shape[0]},) tensor on "
                         f"{data.device}, got {perm.dtype} {tuple(perm.shape)} on {perm.device}")
    shape = (num_segments, data.shape[1])
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=data.device)
    elif (out.dtype != torch.float32 or tuple(out.shape) != shape or out.device != data.device
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, aligned f32 {shape} tensor on "
                         f"{data.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    lib = _build.library("csr_segment")
    rc = lib.mgn_csr_segment_sum(
        data.data_ptr(), _DTYPE_CODES[data.dtype], row_offsets.data_ptr(),
        None if perm is None else perm.data_ptr(), out.data_ptr(),
        num_segments, data.shape[1], CHUNK, torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(lib, rc, "csr_segment_sum")
    if perm is None:
        csr_segment_sum.launches += 1
    else:
        csr_segment_sum.perm_launches += 1
    return out


class _CsrSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, row_offsets, num_segments, perm):
        ctx.save_for_backward(segment_ids)
        ctx.data_dtype = data.dtype
        return torch.ops.mgn_tpu_torch.csr_segment_sum(data, row_offsets, num_segments, perm)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return g.index_select(0, segment_ids).to(ctx.data_dtype), None, None, None, None


def csr_segment_sum(data: torch.Tensor, receivers: torch.Tensor,
                    row_offsets: Optional[torch.Tensor], num_segments: int,
                    perm: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment-sum of ``data`` (E_pad, F) into f32 (N_pad, F).

    ``receivers`` are the segment ids of ``data``'s rows in their own order
    (the senders, for a sender-side sum through ``perm``).  ``out``: an f32
    ``(N_pad, F)`` buffer the sum overwrites and that is returned (no
    gradient flows through that form).  The operator
    ``torch.ops.mgn_tpu_torch.csr_segment_sum`` (``csr_segment_sum_out``
    with ``out``; :mod:`mgn_tpu_torch.ops.library`), whose gradient, where
    one is needed, is the row gather of ``receivers``: CUDA tensor, kernel
    K1, counted in ``csr_segment_sum.launches``, or with ``perm`` in
    ``csr_segment_sum.perm_launches``; CPU tensor, the plain version (which
    alone takes no ``row_offsets``: the identity form).
    """
    if data.device.type not in ("cuda", "cpu"):
        raise ValueError(f"csr_segment_sum runs on cuda or cpu, not {data.device}")
    if row_offsets is None:
        if data.device.type != "cpu":
            raise ValueError("csr_segment_sum kernel needs row_offsets")
        return csr_segment_sum_plain(data, receivers, None, num_segments, perm, out)
    if out is not None:
        torch.ops.mgn_tpu_torch.csr_segment_sum_out(data, row_offsets, num_segments, perm, out)
        return out
    if torch.is_grad_enabled() and data.requires_grad:
        return _CsrSegmentSum.apply(data, receivers, row_offsets, num_segments, perm)
    return torch.ops.mgn_tpu_torch.csr_segment_sum(data, row_offsets, num_segments, perm)


csr_segment_sum.launches = 0
csr_segment_sum.perm_launches = 0
