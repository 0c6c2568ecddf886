"""Checkpoints on ``torch.save``/``torch.load``: the port's
``mgn_tpu/checkpoint/manager.py``.

Two streams, as in the JAX package: periodic checkpoints at the root and
best-validation checkpoints under ``valid/``, each ``step_<n>/model.pt`` with
a ``history.json`` of (step, loss).  A model checkpoint holds the parameter
dict, the normalizer state (:meth:`NormState.state_dict`) and the step —
plain tensors, lists and dicts only, so it loads with ``weights_only=True``.
Optimizer state and resume come with the training slice.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from mgn_tpu_torch._device import tree_to
from mgn_tpu_torch.train.common import NormState

__all__ = ["CheckpointManager"]


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

    def save(self, params: Dict[str, Any], norm: NormState, step: int, loss: float,
             best: bool = False) -> str:
        """Save a model checkpoint (tensors moved to the CPU); appends
        (step, loss) to the stream's history and prunes to ``keep``."""
        d = self.valid_dir if best else self.root
        target = os.path.join(d, f"step_{int(step)}")
        if os.path.exists(target):
            shutil.rmtree(target)
        os.makedirs(target)
        payload = {"params": params, "norm": norm.state_dict(), "step": int(step)}
        tmp = os.path.join(target, "model.pt.tmp")
        torch.save(tree_to(payload, torch.device("cpu")), tmp)
        os.replace(tmp, os.path.join(target, "model.pt"))
        hist = self._load_history(best)
        hist.append({"step": int(step), "loss": float(loss)})
        with open(self._history_path(best), "w") as f:
            json.dump(hist, f)
        for old in self._steps(d)[: -self.keep]:
            shutil.rmtree(os.path.join(d, f"step_{old}"), ignore_errors=True)
        return target

    def latest_step(self, best: bool = False) -> Optional[int]:
        steps = self._steps(self.valid_dir if best else self.root)
        return steps[-1] if steps else None

    def restore_model(self, best: bool = False,
                      device: torch.device = torch.device("cpu")) -> Optional[Dict[str, Any]]:
        """The newest checkpoint of a stream as ``{"params", "norm", "step"}``
        on ``device`` (``norm`` a :class:`NormState`), or None."""
        step = self.latest_step(best)
        if step is None:
            return None
        path = os.path.join(self.valid_dir if best else self.root,
                            f"step_{step}", "model.pt")
        payload = torch.load(path, map_location=device, weights_only=True)
        return {"params": payload["params"],
                "norm": NormState.from_state_dict(payload["norm"]).to(device),
                "step": payload["step"]}

    def best_loss(self) -> float:
        """Best (last recorded) validation loss, inf if none."""
        hist = self._load_history(best=True)
        return float(hist[-1]["loss"]) if hist else float("inf")

