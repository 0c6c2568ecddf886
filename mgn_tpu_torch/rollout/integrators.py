"""Fixed-step ODE integrators: the port's ``odeint_fixed`` of
``mgn_tpu/rollout/integrators.py`` (Euler, Heun, RK4, fixed Tsit5) as
Python loops — PyTorch runs eagerly, so ``lax.scan`` becomes a ``for``.
The adaptive Tsit5 solver is not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["FIXED_METHODS", "odeint_fixed"]


def _euler_step(f, y, t, dt):
    return y + dt * f(y, t)


def _heun_step(f, y, t, dt):
    k1 = f(y, t)
    k2 = f(y + dt * k1, t + dt)
    return y + dt * 0.5 * (k1 + k2)


def _rk4_step(f, y, t, dt):
    k1 = f(y, t)
    k2 = f(y + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = f(y + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = f(y + dt * k3, t + dt)
    return y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


# Tsitouras 5(4) coefficients, rounded to f32 as in the JAX package
_TSIT5_C = [float(c) for c in np.array(
    [0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0], np.float32)]
_TSIT5_A = [
    [],
    [0.161],
    [-0.008480655492356989, 0.335480655492357],
    [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
    [5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525],
    [5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383],
    [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774],
]
_TSIT5_B = [float(b) for b in np.array(
    [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774, 0.0], np.float32)]


def _tsit5_step(f, y, t, dt):
    ks = []
    for i in range(7):
        yi = y
        for j, a in enumerate(_TSIT5_A[i]):
            yi = yi + dt * a * ks[j]
        ks.append(f(yi, t + _TSIT5_C[i] * dt))
    dy = sum(b * k for b, k in zip(_TSIT5_B, ks))
    return y + dt * dy


FIXED_METHODS: dict[str, Callable] = {
    "euler": _euler_step,
    "heun": _heun_step,
    "rk4": _rk4_step,
    "tsit5": _tsit5_step,
}


def odeint_fixed(
    f: Callable,
    y0: torch.Tensor,
    saveat: torch.Tensor,
    dt: Optional[float] = None,
    method: str = "euler",
    substeps: Optional[int] = None,
) -> torch.Tensor:
    """Fixed-step integration saving at every ``saveat`` time.

    ``saveat`` is any monotone f32 time grid; the solver takes ``substeps``
    equal steps per save interval (``dt`` derives them from the first
    interval).  Returns ``(T_save, ...)`` with ``out[0] = y0``.
    """
    if method not in FIXED_METHODS:
        raise ValueError(f"unknown method {method!r}; choose one of {sorted(FIXED_METHODS)}")
    stepper = FIXED_METHODS[method]
    if substeps is None:
        substeps = 1 if dt is None else max(
            1, int(round(float(saveat[1] - saveat[0]) / float(dt))))
    ys = [y0]
    y = y0
    for t0, t1 in zip(saveat[:-1], saveat[1:]):
        h = (t1 - t0) / substeps
        for i in range(substeps):
            y = stepper(f, y, t0 + i * h, h)
        ys.append(y)
    return torch.stack(ys)
