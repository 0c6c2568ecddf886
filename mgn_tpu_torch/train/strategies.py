"""Training strategies: frozen config dataclasses.

The port's copy of ``mgn_tpu/train/strategies.py`` (the JAX package is not
imported at run time).  ``Args.training_strategy`` holds one of these, so
configs written for the JAX package carry over unchanged; ``train_network``
dispatches on it (``train/derivative.py``, ``train/solver.py``).

- :class:`DerivativeTraining` — 1-step training on finite-difference targets.
- :class:`SolverTraining` — NeuralODE training, backprop through the rollout.
- :class:`MultipleShooting` — windowed solves from ground-truth initial
  conditions plus a continuity penalty.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

__all__ = ["DerivativeTraining", "SolverTraining", "MultipleShooting",
           "TrainingStrategy", "get_delta"]


@dataclasses.dataclass(frozen=True)
class DerivativeTraining:
    """window_size=0 -> use the whole trajectory; random shuffles timesteps."""

    window_size: int = 0
    random: bool = True


@dataclasses.dataclass(frozen=True)
class SolverTraining:
    """Full-trajectory NeuralODE training over ``tstart:dt:tstop``.

    ``solver`` is a fixed-step method name or ``'tsit5_adaptive'``;
    ``solver_dt`` defaults to ``dt``; ``adaptive_substeps`` bounds the
    controller steps per save interval and ``rtol``/``atol`` are its
    tolerances.
    """

    tstart: float
    dt: float
    tstop: float
    solver: str = "euler"
    solver_dt: Optional[float] = None
    remat: bool = True
    adaptive_substeps: int = 8
    rtol: float = 1e-4
    atol: float = 1e-6


@dataclasses.dataclass(frozen=True)
class MultipleShooting:
    """SolverTraining over overlapping windows of ``interval_size`` save points
    (stride ``interval_size - 1``), each started from ground truth, plus an L1
    continuity penalty between a window's end state and the next window's
    ground-truth start."""

    tstart: float
    dt: float
    tstop: float
    interval_size: int = 10
    continuity_term: float = 100.0
    solver: str = "euler"
    solver_dt: Optional[float] = None
    remat: bool = True
    adaptive_substeps: int = 8
    rtol: float = 1e-4
    atol: float = 1e-6


TrainingStrategy = Union[DerivativeTraining, SolverTraining, MultipleShooting]


def get_delta(strategy: TrainingStrategy, trajectory_length: int) -> int:
    """Steps consumed per trajectory visit."""
    if isinstance(strategy, DerivativeTraining):
        return strategy.window_size if strategy.window_size > 0 else trajectory_length - 1
    return 1
