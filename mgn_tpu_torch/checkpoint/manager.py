"""Checkpoints on ``torch.save``/``torch.load``: the port's
``mgn_tpu/checkpoint/manager.py``.

Two streams, as in the JAX package: periodic checkpoints at the root and
best-validation checkpoints under ``valid/``, each ``step_<n>/`` with a
``history.json`` of (step, loss) per stream.  A step holds

- ``model.pt``: the parameter dict, the normalizer state
  (:meth:`NormState.state_dict`) and the step — what :meth:`restore_model`
  and ``simulate`` read;
- ``full.pt`` (training states only): the optimizer's per-parameter state
  and the step, for exact resume;
- ``host.json`` (when the trainer passes one): host-side loop state such as
  the NumPy RNG's state, so a resumed run draws what an uninterrupted one
  would.

Plain tensors, numbers, lists and dicts only, so every ``.pt`` loads with
``weights_only=True``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from mgn_tpu_torch._device import tree_to
from mgn_tpu_torch.train.common import NormState, TrainState, param_leaves

__all__ = ["CheckpointManager", "load_model"]


class CheckpointManager:
    """Dual-stream checkpoint manager for one run."""

    def __init__(self, path: str, keep: int = 3):
        self.root = os.path.abspath(path)
        self.valid_dir = os.path.join(self.root, "valid")
        os.makedirs(self.valid_dir, exist_ok=True)
        self.keep = keep

    @staticmethod
    def _steps(d: str) -> List[int]:
        out = []
        if os.path.isdir(d):
            for name in os.listdir(d):
                m = re.fullmatch(r"step_(\d+)", name)
                if m and os.path.isfile(os.path.join(d, name, "model.pt")):
                    out.append(int(m.group(1)))
        return sorted(out)

    def _history_path(self, best: bool) -> str:
        return os.path.join(self.valid_dir if best else self.root, "history.json")

    def _load_history(self, best: bool) -> List[Dict[str, float]]:
        p = self._history_path(best)
        if os.path.isfile(p):
            with open(p) as f:
                return json.load(f)
        return []

    def _step_dir(self, best: bool, step: int) -> str:
        return os.path.join(self.valid_dir if best else self.root, f"step_{int(step)}")

    @staticmethod
    def _write(obj: Any, path: str) -> None:
        tmp = path + ".tmp"
        torch.save(tree_to(obj, torch.device("cpu")), tmp)
        os.replace(tmp, path)

    def save(self, state: TrainState, loss: float, best: bool = False,
             host: Optional[Dict[str, Any]] = None) -> str:
        """Save a checkpoint of ``state`` (tensors moved to the CPU); appends
        (step, loss) to the stream's history and prunes to ``keep``.
        ``host``: JSON-serialisable loop state stored beside it."""
        d = self.valid_dir if best else self.root
        step = int(state.step)
        target = self._step_dir(best, step)
        if os.path.exists(target):
            shutil.rmtree(target)
        os.makedirs(target)
        if state.optimizer is not None:
            self._write({"optimizer": state.optimizer.state_dict()["state"], "step": step},
                        os.path.join(target, "full.pt"))
        if host is not None:
            with open(os.path.join(target, "host.json"), "w") as f:
                json.dump(host, f)
        self._write({"params": _detached(state.params), "norm": state.norm.state_dict(),
                     "step": step}, os.path.join(target, "model.pt"))
        hist = self._load_history(best)
        hist.append({"step": step, "loss": float(loss)})
        with open(self._history_path(best), "w") as f:
            json.dump(hist, f)
        for old in self._steps(d)[: -self.keep]:
            shutil.rmtree(os.path.join(d, f"step_{old}"), ignore_errors=True)
        return target

    def latest_step(self, best: bool = False) -> Optional[int]:
        steps = self._steps(self.valid_dir if best else self.root)
        return steps[-1] if steps else None

    def restore(self, state: TrainState, best: bool = False
                ) -> Optional[Tuple[TrainState, List[Dict[str, float]], Optional[Dict[str, Any]]]]:
        """Restore the newest checkpoint of a stream into ``state`` (None if
        the stream is empty): parameters are copied into ``state.params``'
        tensors in place (the optimizer holds them), normalizers and step
        replaced, and the optimizer's per-parameter state loaded when the
        checkpoint has one (a model-only checkpoint leaves it fresh).
        Returns ``(state, history, host)``."""
        step = self.latest_step(best)
        if step is None:
            return None
        target = self._step_dir(best, step)
        device = param_leaves(state.params)[0].device
        model = torch.load(os.path.join(target, "model.pt"), map_location=device,
                           weights_only=True)
        with torch.no_grad():
            for dst, src in zip(param_leaves(state.params), param_leaves(model["params"]),
                                strict=True):
                dst.copy_(src)
        state.norm = NormState.from_state_dict(model["norm"]).to(device)
        state.step = int(model["step"])
        full = os.path.join(target, "full.pt")
        if state.optimizer is not None and os.path.isfile(full):
            payload = torch.load(full, map_location=device, weights_only=True)
            sd = state.optimizer.state_dict()
            sd["state"] = payload["optimizer"]
            state.optimizer.load_state_dict(sd)
        host = None
        host_path = os.path.join(target, "host.json")
        if os.path.isfile(host_path):
            with open(host_path) as f:
                host = json.load(f)
        return state, self._load_history(best), host

    def restore_model(self, best: bool = False,
                      device: torch.device = torch.device("cpu")) -> Optional[Dict[str, Any]]:
        """The newest checkpoint of a stream as ``{"params", "norm", "step"}``
        on ``device`` (``norm`` a :class:`NormState`), or None."""
        step = self.latest_step(best)
        if step is None:
            return None
        path = os.path.join(self._step_dir(best, step), "model.pt")
        payload = torch.load(path, map_location=device, weights_only=True)
        return {"params": payload["params"],
                "norm": NormState.from_state_dict(payload["norm"]).to(device),
                "step": payload["step"]}

    def best_loss(self) -> float:
        """Best (last recorded) validation loss, inf if none."""
        hist = self._load_history(best=True)
        return float(hist[-1]["loss"]) if hist else float("inf")


def load_model(cp_path: str, use_valid: bool, device: torch.device) -> Tuple[Any, NormState]:
    """The ``(params, norm)`` a rollout runs with, on ``device``: the
    best-validation checkpoint where ``use_valid`` and one exists, else the
    newest periodic one.  Raises ``FileNotFoundError`` where there is none."""
    ckpt = CheckpointManager(cp_path)
    best = use_valid and ckpt.latest_step(best=True) is not None
    model = ckpt.restore_model(best=best, device=device)
    if model is None:
        raise FileNotFoundError(f"no checkpoint found under {cp_path}")
    return tree_to(model["params"], device), model["norm"]


def _detached(tree: Any) -> Any:
    """The same nesting with every tensor detached (parameters that require
    grad pickle their autograd flag otherwise)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree
