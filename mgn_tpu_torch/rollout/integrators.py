"""ODE integrators: the port's ``odeint_fixed`` (Euler, Heun, RK4, fixed
Tsit5) and ``odeint_tsit5_adaptive`` of ``mgn_tpu/rollout/integrators.py``
as Python loops — PyTorch runs eagerly, so ``lax.scan`` becomes a ``for``
and ``lax.while_loop`` a ``while``.  The bounded differentiable variant
(``odeint_tsit5_bounded``) comes with solver training (ROADMAP.md, A3).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["FIXED_METHODS", "odeint_fixed", "odeint_tsit5_adaptive"]


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
# embedded error weights (b - b_hat), f32 as in the JAX package
_TSIT5_BTILDE = [float(b) for b in np.array(
    [-0.001780011052226, -0.000816434459657, 0.007880878010262, -0.144711007173263,
     0.582357165452555, -0.458082105929187, 1.0 / 66.0], np.float32)]


def _tsit5_stages(f, y, t, dt):
    ks = []
    for i in range(7):
        yi = y
        for j, a in enumerate(_TSIT5_A[i]):
            yi = yi + dt * a * ks[j]
        ks.append(f(yi, t + _TSIT5_C[i] * dt))
    return ks


def _tsit5_step(f, y, t, dt):
    ks = _tsit5_stages(f, y, t, dt)
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


def odeint_tsit5_adaptive(
    f: Callable,
    y0: torch.Tensor,
    saveat: torch.Tensor,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    dt0: Optional[float] = None,
    max_steps_per_interval: int = 1000,
    safety: float = 0.9,
    axis_name: Optional[str] = None,
    stats: Optional[List[Tuple[int, int]]] = None,
) -> torch.Tensor:
    """Adaptive Tsit5 with a PI controller, stepping exactly onto every save
    point: ``mgn_tpu.rollout.integrators.odeint_tsit5_adaptive``, forward
    only.  ``saveat`` is any monotone time grid; returns ``(T_save, ...)``
    with ``out[0] = y0``.

    Per save interval ``[t0, t1)`` it tries steps ``h = min(dt, t1 - t)``
    while ``t < t1 - 1e-7`` and fewer than ``max_steps_per_interval`` tries
    were made (then it stops silently, as the JAX ``while_loop`` does).  A
    try is accepted where the RMS ``e`` of the embedded error over ``atol +
    rtol * max(|y|, |y_new|)`` (plus 1e-12) is at most 1; either way ``dt =
    clip(dt * clip(safety e^-0.38 (e_prev / e)^0.04, 0.2, 5), 1e-4 w, 10
    w)``, ``w`` the interval's width and ``e_prev`` the last accepted try's
    ``e``.  ``dt`` and ``e_prev`` carry across intervals.

    The controller runs on the host in f32 0-dim tensors, as the JAX scalars
    are f32 (the exponents too): Python floats would move the ``1e-7`` end
    test and the step counts off JAX's.  ``f`` gets each stage's time on
    ``y0``'s device.  Cost: each try copies ``e`` to the host, so a save
    interval of ``k`` tries makes ``k`` host syncs, each waiting for the
    try's seven ``f`` calls to finish on the device, plus seven small
    host-to-device copies of the stage times.

    ``stats``: a list that receives ``(accepted, rejected)`` tries per
    interval.  ``axis_name`` (the JAX package's global error norm over a
    sharded state) comes with the graph-parallel port (ROADMAP.md, A7).
    """
    if axis_name is not None:
        raise NotImplementedError("odeint_tsit5_adaptive(axis_name=): the sharded error norm "
                                  "comes with graph-parallel rollouts (ROADMAP.md, A7)")
    f32, dev = torch.float32, y0.device
    grid = saveat.detach().to("cpu", f32)
    # the controller's exponents as f32, as JAX rounds its weak-typed constants
    p_err, p_ratio = torch.tensor(-0.38, dtype=f32), torch.tensor(0.04, dtype=f32)
    dt = torch.tensor(dt0, dtype=f32) if dt0 is not None else grid[1] - grid[0]
    err_prev = torch.ones((), dtype=f32)

    def f_dev(y, t):
        return f(y, t.to(dev))

    ys, y = [y0], y0
    for t_start, t_end in zip(grid[:-1], grid[1:]):
        dt_ref = t_end - t_start
        t, tries, accepted = t_start, 0, 0
        while bool(t < t_end - 1e-7) and tries < max_steps_per_interval:
            h = torch.minimum(dt, t_end - t)
            ks = _tsit5_stages(f_dev, y, t, h)
            dy = sum(b * k for b, k in zip(_TSIT5_B, ks))
            yerr = h * sum(b * k for b, k in zip(_TSIT5_BTILDE, ks))
            ynew = y + h * dy
            scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(ynew))
            e = (torch.sqrt(torch.mean((yerr / scale) ** 2)) + 1e-12).to("cpu", f32)  # the sync
            fac = torch.clamp(safety * e ** p_err * (err_prev / e) ** p_ratio, 0.2, 5.0)
            dt = torch.minimum(torch.maximum(dt * fac, dt_ref * 1e-4), dt_ref * 10.0)
            if bool(e <= 1.0):
                t, y, err_prev = t + h, ynew, e
                accepted += 1
            tries += 1
        if stats is not None:
            stats.append((accepted, tries - accepted))
        ys.append(y)
    return torch.stack(ys)
