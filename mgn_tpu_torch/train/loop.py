"""The training loop that every ``train_network`` path runs: the host
state saved with each checkpoint (:class:`HostLoop`), the resume
(:func:`resume`) and the loop itself (:func:`train_loop`) around a
family's and a layout's window and validation loss."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.parallel.mesh import is_writer
from mgn_tpu_torch.train.common import TrainState
from mgn_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["HostLoop", "resume", "train_loop"]


@dataclasses.dataclass
class HostLoop:
    """The training loop's host state, saved with every checkpoint: the
    frame RNG, the next trajectory's index and the steps since the last
    checkpoint."""

    rng: np.random.Generator
    traj_idx: int = 0
    cp_progress: int = 0

    def state(self) -> Dict[str, Any]:
        return {"rng": self.rng.bit_generator.state, "traj_idx": self.traj_idx,
                "cp_progress": self.cp_progress}


def resume(ckpt: CheckpointManager, state: TrainState, host: HostLoop, args: Args,
           log: MetricsLogger) -> Tuple[TrainState, float]:
    """The newest periodic checkpoint under ``ckpt`` restored into
    ``state`` (parameters, optimizer, normalizers, step) and ``host`` (the
    frame RNG, the trajectory index, the checkpoint progress), where there
    is one; returns the state and the best validation loss so far (``inf``
    with ``args.reset_valid``)."""
    restored = ckpt.restore(state)
    if restored is not None:
        state, _, saved = restored
        if saved is not None:
            host.rng.bit_generator.state = saved["rng"]
            host.traj_idx, host.cp_progress = saved["traj_idx"], saved["cp_progress"]
        log.log("resume", step=state.step)
    return state, float("inf") if args.reset_valid else ckpt.best_loss()


def train_loop(state: TrainState, args: Args, ckpt: CheckpointManager, min_valid: float,
               host: HostLoop, window, valid_loss, num_valid: int, log: MetricsLogger,
               **record: Any) -> Tuple[TrainState, float]:
    """``train_network``'s loop, single-device and graph-parallel, for the
    single-edge-set and the cloth family alike.
    ``window(state, steps_left) -> (state, losses, steps)`` trains one
    window, drawing from and advancing ``host``.  Past the warm-up
    (``norm_steps``), every ``checkpoint`` steps: the validation sweep (the
    mean of ``valid_loss(state, i)``, each validation trajectory's masked
    rollout MSE, without gradients), then the best and the periodic
    checkpoints with ``host``'s state, written by this process only where
    :func:`~mgn_tpu_torch.parallel.mesh.is_writer`.  ``record``: fields added to
    every ``train`` and ``valid`` record."""
    total_steps = int(args.steps * args.epochs)
    writer = is_writer()

    def save(loss: float, best: bool = False) -> None:
        if writer:
            ckpt.save(state, loss, best=best, host=host.state())

    losses = torch.zeros((0,))  # stays empty if already past total_steps
    t_last = time.time()
    while state.step < total_steps:
        state, losses, n_done = window(state, total_steps - state.step)
        host.cp_progress += n_done
        dt_wall = time.time() - t_last
        t_last = time.time()
        log.log("train", step=state.step, loss=float(losses.mean()),
                steps_per_s=n_done / max(dt_wall, 1e-9),
                warming_up=bool(state.step <= args.norm_steps), **record)

        if state.step > args.norm_steps and host.cp_progress >= args.checkpoint:
            host.cp_progress = 0
            with torch.no_grad():
                total = sum(float(valid_loss(state, i)) for i in range(num_valid))
            valid = total / max(num_valid, 1)
            log.log("valid", step=state.step, loss=valid, **record)
            if valid < min_valid:
                min_valid = valid
                save(valid, best=True)
            save(float(losses.mean()))
            log.log("checkpoint", step=state.step, valid_loss=valid, min_valid_loss=min_valid)

    if len(losses):  # a resume past completion trains nothing; keep checkpoints
        save(float(losses.mean()))
    return state, min_valid
