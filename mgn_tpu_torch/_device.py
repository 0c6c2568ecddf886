"""Device selection for the port's entry points.

The port runs on an NVIDIA GPU.  ``device=None`` therefore means the first
CUDA device and raises when there is none: nothing falls back to the CPU
quietly.  Callers that want the plain PyTorch path on the CPU (the tests)
pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

__all__ = ["resolve_device", "tracing", "tree_to"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); otherwise ``cuda`` or ``cpu``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: mgn_tpu_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def tracing() -> bool:
    """Whether the calling code runs under a trace (``torch.export``, or
    ``torch.compile``'s, through which a ``while_loop`` body is traced),
    where host reads and in-place collectives have no place."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def tree_to(tree: Any, device: torch.device) -> Any:
    """Move every tensor of a nested dict/list/tuple to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree
