"""ODE integrators: the port's ``odeint_fixed`` (Euler, Heun, RK4, fixed
Tsit5), ``odeint_tsit5_adaptive`` and ``odeint_tsit5_bounded`` of
``mgn_tpu/rollout/integrators.py`` as Python loops — PyTorch runs eagerly,
so ``lax.scan`` becomes a ``for`` and ``lax.while_loop`` a ``while`` — and
``odeint_tsit5_loop``, the adaptive controller on the device under
``torch._higher_order_ops.while_loop`` (what a serving artefact traces).
``odeint_fixed`` and ``odeint_tsit5_bounded`` are differentiable (solver
training backpropagates through them); with ``remat=True`` each substep
runs under ``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch._higher_order_ops import while_loop
from torch.utils.checkpoint import checkpoint

__all__ = ["FIXED_METHODS", "odeint_fixed", "odeint_tsit5_adaptive", "odeint_tsit5_loop",
           "odeint_tsit5_bounded"]


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
    remat: bool = False,
    substeps: Optional[int] = None,
) -> torch.Tensor:
    """Fixed-step integration saving at every ``saveat`` time.

    ``saveat`` is any monotone f32 time grid; the solver takes ``substeps``
    equal steps per save interval (``dt`` derives them from the first
    interval).  ``remat=True`` runs each step under non-reentrant
    ``torch.utils.checkpoint`` (solver training): the backward keeps only
    each step's input state and runs the step's forward again, which gives
    the same values and gradients where ``f`` is deterministic.  Returns
    ``(T_save, ...)`` with ``out[0] = y0``.
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
            y = (checkpoint(stepper, f, y, t0 + i * h, h, use_reentrant=False) if remat
                 else stepper(f, y, t0 + i * h, h))
        ys.append(y)
    return torch.stack(ys)


def _tsit5_try(f, y, t, h, rtol, atol, group=None):
    """One adaptive Tsit5 try from ``(t, y)`` with step ``h``: the new state
    and ``e``, the RMS of the embedded error over ``atol + rtol * max(|y|,
    |y_new|)``, plus 1e-12.  With ``group`` (a
    :class:`~mgn_tpu_torch.parallel.mesh.Comm`) the RMS is the whole
    sharded state's: the squared error sum and the element count summed
    over the group in one ``all_reduce``."""
    ks = _tsit5_stages(f, y, t, h)
    dy = sum(b * k for b, k in zip(_TSIT5_B, ks))
    yerr = h * sum(b * k for b, k in zip(_TSIT5_BTILDE, ks))
    ynew = y + h * dy
    scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(ynew))
    sq = (yerr / scale) ** 2
    if group is None:
        e = torch.sqrt(torch.mean(sq))
    else:
        tot = group.all_reduce(torch.stack([sq.sum(), torch.full_like(sq.sum(), sq.numel())]))
        e = torch.sqrt(tot[0] / tot[1])
    return ynew, e + 1e-12


def _pi_step(dt, e, err_prev, dt_ref, safety, p_err, p_ratio):
    """The PI controller's next step size: ``clip(dt * clip(safety e^p_err
    (e_prev / e)^p_ratio, 0.2, 5), 1e-4 w, 10 w)``, ``w`` the save
    interval's width ``dt_ref``."""
    fac = torch.clamp(safety * e ** p_err * (err_prev / e) ** p_ratio, 0.2, 5.0)
    return torch.minimum(torch.maximum(dt * fac, dt_ref * 1e-4), dt_ref * 10.0)


def _exponents(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The controller's exponents as f32 0-dim tensors, as JAX rounds its
    weak-typed constants (a Python-float exponent in torch's 0-dim ``pow``
    gives other bits than XLA's)."""
    return (torch.full((), -0.38, dtype=torch.float32, device=device),
            torch.full((), 0.04, dtype=torch.float32, device=device))


def odeint_tsit5_adaptive(
    f: Callable,
    y0: torch.Tensor,
    saveat: torch.Tensor,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    dt0: Optional[float] = None,
    max_steps_per_interval: int = 1000,
    safety: float = 0.9,
    group=None,
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
    host-to-device copies of the stage times.  :func:`odeint_tsit5_loop` is
    the same controller on the device, which ``torch.export`` traces.

    ``stats``: a list that receives ``(accepted, rejected)`` tries per
    interval.  ``group`` (a :class:`~mgn_tpu_torch.parallel.mesh.Comm`;
    the JAX package's ``axis_name``): the state is one part of a sharded
    state, and the error norm is the whole state's: the squared error sum
    and the element count are summed over the group in one ``all_reduce``
    (on the device, before the sync), so every rank accepts, rejects and
    sizes the same step.  The count takes in every part's padded rows (P *
    N_p, as the JAX ``psum`` does), so the step sizes are those of one
    device only where its bucket has as many rows.
    """
    f32, dev = torch.float32, y0.device
    grid = saveat.detach().to("cpu", f32)
    p_err, p_ratio = _exponents("cpu")
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
            ynew, e = _tsit5_try(f_dev, y, t, h, rtol, atol, group)
            e = e.to("cpu", f32)  # the sync
            dt = _pi_step(dt, e, err_prev, dt_ref, safety, p_err, p_ratio)
            if bool(e <= 1.0):
                t, y, err_prev = t + h, ynew, e
                accepted += 1
            tries += 1
        if stats is not None:
            stats.append((accepted, tries - accepted))
        ys.append(y)
    return torch.stack(ys)


def odeint_tsit5_loop(
    f: Callable,
    y0: torch.Tensor,
    saveat: torch.Tensor,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    dt0: Optional[float] = None,
    max_steps_per_interval: int = 1000,
    safety: float = 0.9,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`odeint_tsit5_adaptive` with its controller on the device:
    ``torch._higher_order_ops.while_loop`` over the save intervals around a
    ``while_loop`` over one interval's tries, the counterpart of the JAX
    ``lax.scan`` around ``advance_to``'s ``lax.while_loop``.  Each try
    carries ``(t, y, dt, e_prev, tries, accepted)`` as tensors, runs one
    Tsit5 try and the PI controller in f32 and applies the accept decision
    with ``torch.where``, as JAX does; ``group`` sums the error norm over a
    graph group inside the loop (the collective traces as its functional
    form), so every rank takes the same decisions.  The graph that
    ``torch.export`` makes of it holds one try's body once, and the rollout
    makes no host sync.  On the CPU it gives :func:`odeint_tsit5_adaptive`'s
    bits and tries.

    Returns ``(ys (T_save, ...), tries (T_save - 1, 2) int32)``, the
    ``(accepted, rejected)`` tries of each save interval.  Called outside a
    trace, each ``while_loop`` runs through ``torch.compile`` (PyTorch's
    eager route for the operator), which compiles ``f`` first."""
    f32, dev = torch.float32, y0.device
    grid = saveat.to(f32)
    n = grid.shape[0]
    p_err, p_ratio = _exponents(dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def interval(y, dt, err_prev, t_start, t_end):
        dt_ref = t_end - t_start

        def cond(t, y, dt, err_prev, tries, accepted):
            return (t < t_end - 1e-7) & (tries < max_steps_per_interval)

        def body(t, y, dt, err_prev, tries, accepted):
            h = torch.minimum(dt, t_end - t)
            ynew, e = _tsit5_try(f, y, t, h, rtol, atol, group)
            dt_next = _pi_step(dt, e, err_prev, dt_ref, safety, p_err, p_ratio)
            accept = e <= 1.0
            return (torch.where(accept, t + h, t), torch.where(accept, ynew, y), dt_next,
                    torch.where(accept, e, err_prev), tries + 1, accepted + accept.to(torch.int32))

        zero = torch.zeros((), **i32)
        return while_loop(cond, body, (t_start.clone(), y, dt, err_prev, zero, zero.clone()))

    def outer_cond(i, y, dt, err_prev, ys, tries):
        return i < n - 1

    def outer_body(i, y, dt, err_prev, ys, tries):
        k = i.reshape(1)
        t_start, t_end = grid.index_select(0, k)[0], grid.index_select(0, k + 1)[0]
        _, y, dt, err_prev, made, accepted = interval(y, dt, err_prev, t_start, t_end)
        return (i + 1, y.clone(), dt.clone(), err_prev.clone(),
                ys.index_copy(0, k + 1, y[None]),
                tries.index_copy(0, k, torch.stack([accepted, made - accepted])[None]))

    dt = (torch.full((), dt0, dtype=f32, device=dev) if dt0 is not None
          else grid[1] - grid[0])
    ys = torch.cat([y0[None], y0.new_zeros((n - 1,) + tuple(y0.shape))])
    out = while_loop(outer_cond, outer_body,
                     (torch.zeros((), dtype=torch.int64, device=dev), y0, dt,
                      torch.ones((), dtype=f32, device=dev), ys,
                      torch.zeros((n - 1, 2), **i32)))
    return out[4], out[5]


def odeint_tsit5_bounded(
    f: Callable,
    y0: torch.Tensor,
    saveat: torch.Tensor,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    substeps_max: int = 8,
    safety: float = 0.9,
    remat: bool = False,
    group=None,
    stats: Optional[List[Tuple[int, int]]] = None,
) -> torch.Tensor:
    """Differentiable adaptive Tsit5 with a budget of ``substeps_max``
    controller steps per save interval:
    ``mgn_tpu.rollout.integrators.odeint_tsit5_bounded``, the trainable
    counterpart of :func:`odeint_tsit5_adaptive`.  Returns ``(T_save,
    ...)`` with ``out[0] = y0``.

    Per save interval ``[t0, t1)`` of width ``w``, substep ``i`` first tests
    ``t1 - t <= 1e-7 |w|`` (the interval is done); otherwise it tries ``h =
    min(dt, t1 - t)``, or ``t1 - t`` on the budget's last substep, which is
    always accepted and so lands on ``t1``.  Any other try is accepted where
    ``e``, the RMS of the embedded error over ``atol + rtol * max(|y|,
    |y_new|)`` (``sqrt(mean + 1e-24) + 1e-12``), is at most 1; either way
    ``dt = clip(dt * clip(safety e^-0.38 (e_prev / e)^0.04, 0.2, 5), 1e-4 w,
    10 w)``, ``e_prev`` the last accepted try's ``e``.  ``dt`` and
    ``e_prev`` carry across intervals; ``dt`` starts at ``saveat[1] -
    saveat[0]``.

    Gradients are the discrete adjoint of the realised steps: step sizes and
    accept decisions carry none (a frozen controller, as the JAX function's
    ``stop_gradient``s make it), so they flow through the accepted RK
    updates only.  ``remat=True`` runs each try's seven stages under
    non-reentrant ``torch.utils.checkpoint``.

    The JAX function runs all ``substeps_max`` substeps of every interval
    (``lax.scan`` needs a static count) and throws away those after the
    interval is done with ``jnp.where``; this one stops the interval there.
    Values and gradients are the same, with fewer forwards.

    The controller runs on the host in f32 0-dim tensors, as in
    :func:`odeint_tsit5_adaptive` (whose docstring says why): one host sync
    (``e.to("cpu")``) a try.  ``stats``: a list that receives ``(accepted,
    rejected)`` tries per interval.  ``group`` (a
    :class:`~mgn_tpu_torch.parallel.mesh.Comm`; the JAX package's
    ``axis_name``, for graph-parallel solver training): the state is one part
    of a sharded state, and the error norm is the whole state's, its squared
    error sum and element count summed over the group in one ``all_reduce``
    before the sync, so every rank accepts, rejects and sizes the same step.
    The count takes in every part's padded rows (P * N_p, as the JAX
    ``psum`` does): graph parallelism changes the step sizes, and they are
    one device's only where its node bucket has P * N_p rows.
    """
    f32, dev = torch.float32, y0.device
    grid = saveat.detach().to("cpu", f32)
    p_err, p_ratio = _exponents("cpu")
    dt = grid[1] - grid[0]
    err_prev = torch.ones((), dtype=f32)

    def f_dev(y, t):
        return f(y, t.to(dev))

    def attempt(y, t, h):
        ks = _tsit5_stages(f_dev, y, t, h)
        dy = sum(b * k for b, k in zip(_TSIT5_B, ks))
        yerr = h * sum(b * k for b, k in zip(_TSIT5_BTILDE, ks))
        return y + h * dy, yerr

    ys, y = [y0], y0
    for t_start, t_end in zip(grid[:-1], grid[1:]):
        dt_ref = t_end - t_start
        t, tries, accepted = t_start, 0, 0
        for i in range(substeps_max):
            remaining = t_end - t
            if bool(remaining <= 1e-7 * torch.abs(dt_ref)):
                break  # done: JAX's later substeps of the interval are no-ops
            last = i == substeps_max - 1
            h = remaining if last else torch.minimum(dt, remaining)
            ynew, yerr = (checkpoint(attempt, y, t, h, use_reentrant=False) if remat
                          else attempt(y, t, h))
            with torch.no_grad():
                scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(ynew))
                sq = (yerr / scale) ** 2
                if group is None:
                    ms = torch.mean(sq)
                else:
                    tot = group.all_reduce(torch.stack([sq.sum(), torch.full_like(
                        sq.sum(), sq.numel())]))
                    ms = tot[0] / tot[1]
                e = (torch.sqrt(ms + 1e-24) + 1e-12).to("cpu", f32)  # the sync
            dt = _pi_step(dt, e, err_prev, dt_ref, safety, p_err, p_ratio)
            if last or bool(e <= 1.0):
                t, y, err_prev = t + h, ynew, e
                accepted += 1
            tries += 1
        if stats is not None:
            stats.append((accepted, tries - accepted))
        ys.append(y)
    return torch.stack(ys)
