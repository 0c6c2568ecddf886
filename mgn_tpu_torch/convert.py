"""Carry weights and normalizer state from the JAX package to the port.

The port never reads orbax.  The caller restores a JAX checkpoint with the
JAX package and hands over plain numpy trees, for example::

    model = CheckpointManager(cp).restore_model(abstract)   # mgn_tpu
    model_np = jax.tree.map(np.asarray, model)
    save_checkpoint_from_jax(model_np, "cp_torch")          # mgn_tpu_torch

The parameter tree has the same layout in both packages (``w (in, out)``,
processor leaves stacked on ``(mps,)``), so :func:`params_from_jax` only
turns arrays into tensors.  :func:`norm_from_jax` reads a ``NormState`` by
its fields (``edge``/``node``/``output``) and recognises each normalizer by
the fields it carries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.train.common import NormState

__all__ = ["params_from_jax", "norm_from_jax", "save_checkpoint_from_jax"]


def params_from_jax(tree: Any) -> Any:
    """Nested dicts/lists of arrays -> the same nesting of f32 CPU tensors."""
    if isinstance(tree, Mapping):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _normalizer_from_jax(n: Any) -> N.Normalizer:
    if hasattr(n, "acc_sum"):
        cls = N.Online
    elif hasattr(n, "data_min"):
        cls = N.OfflineMinMax
    elif hasattr(n, "mean") and hasattr(n, "std"):
        cls = N.OfflineMeanStd
    else:
        raise ValueError(f"unrecognised normalizer {type(n).__name__}")
    return cls(**{f.name: torch.from_numpy(np.array(getattr(n, f.name), dtype=np.float32))
                  for f in dataclasses.fields(cls)})


def norm_from_jax(norm: Any) -> NormState:
    """A JAX ``NormState`` (numpy leaves) -> the port's :class:`NormState`."""
    return NormState(
        edge=_normalizer_from_jax(norm.edge),
        node={k: _normalizer_from_jax(v) for k, v in norm.node.items()},
        output={k: _normalizer_from_jax(v) for k, v in norm.output.items()})


def save_checkpoint_from_jax(model_np: Mapping[str, Any], cp_path: str,
                             loss: float = 0.0, best: bool = False,
                             step: Optional[int] = None) -> str:
    """Write a port checkpoint from a JAX model tree ``{"params", "norm",
    "step"}`` of numpy leaves; returns the checkpoint directory."""
    if step is None:
        step = int(np.asarray(model_np.get("step", 0)))
    return CheckpointManager(cp_path).save(
        params_from_jax(model_np["params"]), norm_from_jax(model_np["norm"]),
        step=step, loss=loss, best=best)
