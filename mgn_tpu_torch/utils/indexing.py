"""Grid linear/cartesian index helpers: the port's copy of
``mgn_tpu/utils/indexing.py``.

Parity with the reference's index utilities (``li_to_ci`` / ``ci_to_li`` /
``dims_to_li``), 0-based and column-major (Fortran order) to match the
Julia ``LinearIndices`` convention the grid-mesh datasets use.
"""

from __future__ import annotations

from typing import Sequence, Tuple

__all__ = ["li_to_ci", "ci_to_li", "dims_to_li"]


def li_to_ci(dims: Sequence[int], li: int) -> Tuple[int, ...]:
    """Linear index -> cartesian index (column-major, 0-based)."""
    out = []
    for d in dims:
        out.append(li % d)
        li //= d
    return tuple(out)


def ci_to_li(dims: Sequence[int], ci: Sequence[int]) -> int:
    """Cartesian index -> linear index (column-major, 0-based)."""
    li = 0
    stride = 1
    for d, i in zip(dims, ci):
        if not 0 <= i < d:
            raise IndexError(f"index {i} out of range for dim {d}")
        li += i * stride
        stride *= d
    return li


def dims_to_li(dims: Sequence[int], idx: Sequence[int]) -> int:
    """Alias of :func:`ci_to_li` (the reference's name for it)."""
    return ci_to_li(dims, idx)
