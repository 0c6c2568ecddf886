"""Gather/scatter message-passing primitives: the port's
``mgn_tpu/ops/segment.py``.

``segment_sum`` accepts the JAX package's backend names ('auto', 'xla',
'pallas', 'banded') so configs carry over; on every backend it reduces
through :func:`mgn_tpu_torch.ops.csr_segment.csr_segment_sum` — kernel K1 on
a CUDA tensor, its plain version on a CPU tensor.  The one-hot 'banded'
formulation is a TPU device; a GPU gathers rows directly.  The result is f32
(K1's accumulator), like the TPU's Pallas backend; callers cast.

Unsorted ids (the cloth family's world edges, which come out sorted by
sender) are summed through K1's permutation path: a stable receiver order
and its CSR offsets are made on the device, with no host sync and no
atomics, so the sum is deterministic.  The JAX package sums unsorted ids with
``jax.ops.segment_sum`` in the data's dtype; the port sums in f32 (bf16
data included).

:func:`gather_ordered` is the row gather of such ids where a gradient is
needed: ``index_select``'s backward on a CUDA tensor is an atomic
``index_add_``, whose f32 sums can differ from run to run, so its backward
sums the cotangent rows through K1 and the ids' :func:`csr_order` instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mgn_tpu_torch.ops.csr_segment import csr_segment_sum

__all__ = ["gather", "gather_ordered", "segment_sum", "csr_order"]

_BACKENDS = (None, "auto", "xla", "pallas", "banded")


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]`` — sender/receiver feature lookup, (E, F)."""
    return x.index_select(0, idx)


class _GatherOrdered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, perm, offsets):
        ctx.save_for_backward(idx, perm, offsets)
        ctx.rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, perm, offsets = ctx.saved_tensors
        dx = csr_segment_sum(g.contiguous(), idx, offsets, ctx.rows, perm=perm)
        return dx.to(g.dtype), None, None, None


def gather_ordered(x: torch.Tensor, idx: torch.Tensor, perm: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]`` whose gradient sums the cotangent rows by
    ``idx`` through K1's permutation path (f32, then ``x``'s dtype), in a
    fixed order: two backward passes give the same bits.  ``(perm,
    offsets)`` is :func:`csr_order` of ``idx`` over ``x``'s rows; rows it
    leaves out (``valid`` false) add nothing to the gradient, so their
    cotangent must be zero, as a masked message's is.  On the CPU the sum
    is the plain ``index_add_``."""
    return _GatherOrdered.apply(x, idx, perm, offsets)


def csr_order(segment_ids: torch.Tensor, num_segments: int,
              valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, row_offsets)``, both int32: the rows in a stable order by id
    and the CSR offsets of that order, made on the ids' device with no host
    sync.  K1 sums unsorted rows through them (``csr_segment_sum(perm=)``);
    a caller that sums the same ids several times makes them once.  Rows
    where the bool ``valid`` is false sort after ``row_offsets[-1]``, in no
    segment, so K1 never reads them."""
    key = segment_ids if valid is None else torch.where(
        valid, segment_ids, torch.full_like(segment_ids, num_segments))
    ordered, perm = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, device=segment_ids.device, dtype=ordered.dtype)
    return perm.to(torch.int32), torch.searchsorted(ordered, bounds).to(torch.int32)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    row_offsets: Optional[torch.Tensor] = None,
    indices_are_sorted: bool = True,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Scatter-add edge rows into node rows, f32: ``out[n] = sum data[e]``
    over ``segment_ids[e] == n``.

    Sorted ids (CSR order): without ``row_offsets`` the offsets are derived
    from the ids.  Unsorted ids (``indices_are_sorted=False``): the rows are
    summed in a stable order by id, through K1's ``perm`` path on a CUDA
    tensor; ``row_offsets``, which describe sorted ids, raise.  Each call
    sorts the ids: a caller that sums the same ids more than once makes
    their order once with :func:`csr_order` and calls ``csr_segment_sum(perm=)``
    itself, as ``models/mgn_multi.py`` does for the world edges.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if not indices_are_sorted:
        if row_offsets is not None:
            raise ValueError("row_offsets describe sorted ids; unsorted ids take none")
        perm, offsets = csr_order(segment_ids, num_segments)
        return csr_segment_sum(data, segment_ids, offsets, num_segments, perm=perm)
    if row_offsets is None:
        bounds = torch.arange(num_segments + 1, device=segment_ids.device,
                              dtype=segment_ids.dtype)
        row_offsets = torch.searchsorted(segment_ids, bounds).to(torch.int32)
    return csr_segment_sum(data, segment_ids, row_offsets, num_segments)
