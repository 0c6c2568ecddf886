"""Carry weights, normalizer state and training state from the JAX package
to the port.

The port never reads orbax.  The caller restores a JAX checkpoint with the
JAX package and hands over plain numpy trees, for example::

    model = CheckpointManager(cp).restore_model(abstract)   # mgn_tpu
    model_np = jax.tree.map(np.asarray, model)
    save_checkpoint_from_jax(model_np, "cp_torch")          # mgn_tpu_torch

    state, _ = CheckpointManager(cp).restore(abstract_state)  # a TrainState
    save_train_state_from_jax(jax.tree.map(np.asarray, state), "cp_torch")

The second writes a full port checkpoint (parameters, normalizers, step and
optax Adam's ``mu``/``nu``/``count`` as ``torch.optim.Adam`` state), from
which ``mgn_tpu_torch.train_network`` resumes a run the JAX package started.

The parameter tree has the same layout in both packages (``w (in, out)``,
processor leaves stacked on ``(mps,)``), so :func:`params_from_jax` only
turns arrays into tensors (the cloth family's lists ``edge_encoders`` and
``edge_mlps`` included).  :func:`norm_from_jax` reads a ``NormState`` by
its fields (``edge``/``node``/``output``) and recognises each normalizer by
the fields it carries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.train.common import NormState, TrainState, param_leaves

__all__ = ["params_from_jax", "norm_from_jax", "adam_state_from_jax",
           "save_checkpoint_from_jax", "save_train_state_from_jax"]


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
    """A JAX ``NormState`` (numpy leaves) -> the port's :class:`NormState`;
    ``edge`` one normalizer or a dict of them (the cloth family's)."""
    return NormState(
        edge=({k: _normalizer_from_jax(v) for k, v in norm.edge.items()}
              if isinstance(norm.edge, Mapping) else _normalizer_from_jax(norm.edge)),
        node={k: _normalizer_from_jax(v) for k, v in norm.node.items()},
        output={k: _normalizer_from_jax(v) for k, v in norm.output.items()})


def save_checkpoint_from_jax(model_np: Mapping[str, Any], cp_path: str,
                             loss: float = 0.0, best: bool = False,
                             step: Optional[int] = None) -> str:
    """Write a port checkpoint from a JAX model tree ``{"params", "norm",
    "step"}`` of numpy leaves; returns the checkpoint directory."""
    if step is None:
        step = int(np.asarray(model_np.get("step", 0)))
    state = TrainState(params=params_from_jax(model_np["params"]), optimizer=None,
                       norm=norm_from_jax(model_np["norm"]), step=step)
    return CheckpointManager(cp_path).save(state, loss=loss, best=best)


def _find_adam(opt_state: Any) -> Any:
    """The optax Adam state (a node with ``mu``, ``nu`` and ``count``) inside
    an optimizer state tree."""
    if all(hasattr(opt_state, k) for k in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        for sub in opt_state:
            found = _find_adam(sub)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state: Any) -> Dict[int, Dict[str, torch.Tensor]]:
    """optax Adam's ``(count, mu, nu)`` -> ``torch.optim.Adam``'s
    per-parameter state, keyed by :func:`param_leaves` position.  The two
    apply the same update (``eps`` outside the square root, bias correction
    by the count of updates), so a resumed run continues the same sequence."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (mu, nu, count) in this optimizer state; "
                         "only Adam carries across")
    count = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    mu, nu = param_leaves(params_from_jax(adam.mu)), param_leaves(params_from_jax(adam.nu))
    return {i: {"step": count.clone(), "exp_avg": m, "exp_avg_sq": v}
            for i, (m, v) in enumerate(zip(mu, nu, strict=True))}


def save_train_state_from_jax(state_np: Any, cp_path: str, loss: float = 0.0) -> str:
    """Write a full port checkpoint from a JAX ``TrainState`` of numpy leaves
    (``params``, ``opt_state`` from ``optax.adam``, ``norm``, ``step``);
    returns the checkpoint directory."""
    params = params_from_jax(state_np.params)
    leaves = param_leaves(params)
    optimizer = torch.optim.Adam(leaves)  # carries the state only: lr etc. are the caller's
    sd = optimizer.state_dict()
    sd["state"] = adam_state_from_jax(state_np.opt_state)
    optimizer.load_state_dict(sd)
    state = TrainState(params=params, optimizer=optimizer, norm=norm_from_jax(state_np.norm),
                       step=int(np.asarray(state_np.step)))
    return CheckpointManager(cp_path).save(state, loss=loss)
