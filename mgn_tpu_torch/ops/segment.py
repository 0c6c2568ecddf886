"""Gather/scatter message-passing primitives: the port's
``mgn_tpu/ops/segment.py``.

``segment_sum`` accepts the JAX package's backend names ('auto', 'xla',
'pallas', 'banded') so configs carry over; on every backend it reduces
through :func:`mgn_tpu_torch.ops.csr_segment.csr_segment_sum` — kernel K1 on
a CUDA tensor, its plain version on a CPU tensor.  The one-hot 'banded'
formulation is a TPU device; a GPU gathers rows directly.  The result is f32
(K1's accumulator), like the TPU's Pallas backend; callers cast.
"""

from __future__ import annotations

from typing import Optional

import torch

from mgn_tpu_torch.ops.csr_segment import csr_segment_sum

__all__ = ["gather", "segment_sum"]

_BACKENDS = (None, "auto", "xla", "pallas", "banded")


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]`` — sender/receiver feature lookup, (E, F)."""
    return x.index_select(0, idx)


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

    The ids must be sorted (CSR order).  Without ``row_offsets`` they are
    derived from the sorted ids.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if not indices_are_sorted:
        raise ValueError("segment_sum needs receiver-sorted ids (CSR order)")
    if row_offsets is None:
        bounds = torch.arange(num_segments + 1, device=segment_ids.device,
                              dtype=segment_ids.dtype)
        row_offsets = torch.searchsorted(segment_ids, bounds).to(torch.int32)
    return csr_segment_sum(data, segment_ids, row_offsets, num_segments)
