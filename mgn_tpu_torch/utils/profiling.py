"""Tracing, timing and debug utilities: the port's
``mgn_tpu/utils/profiling.py`` on ``torch.profiler``.

- :func:`trace` — a context manager around ``torch.profiler.profile`` (CPU
  activity, and CUDA's where a GPU is present) that writes a Chrome trace
  (Perfetto, ``chrome://tracing``) under ``log_dir``; on a GPU its block
  runs between guards (:func:`guarded_profile`);
- :func:`guarded_profile` — a profile whose block runs between guard
  kernels, and says whether it kept every device event of the block;
- :func:`timed` — host-clock seconds per call of a function after warm-up
  calls, each call ending in a device synchronize (PyTorch returns before
  the GPU finishes);
- :func:`edges_per_sec` — the headline throughput counter;
- :func:`debug_mode` — NaN checks through autograd's anomaly detection;
  ``disable_jit`` is accepted and does nothing, PyTorch being eager.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Any, Callable, List

import torch

__all__ = ["trace", "guarded_profile", "GuardedProfile", "timed", "edges_per_sec",
           "debug_mode"]

# What a GPU profile wraps around the block it records.  ``torch.profiler``
# can drop the device events at either end of its session, and the stretch
# it drops grows with the process's age (``probes/profiler_drift``: 50 short
# kernels profiled alone kept 14 of 50 at 457 s into a process on an H100).
# So the block runs between guards: a host wait, GUARD_SPINS short spin
# kernels (``torch.cuda._sleep``) and a synchronize before it; a
# synchronize, a ~5 ms spin and GUARD_SPINS more after it.  A profile whose
# first and last device events are guard spins lost nothing of the block.
SETTLE_S = 0.05
GUARD_SPINS = 256
SENTINEL = "spin_kernel"  # the kernel torch.cuda._sleep launches


@dataclasses.dataclass
class GuardedProfile:
    """What :func:`guarded_profile` yields: ``prof`` (the
    ``torch.profiler.profile``) during and after the block; after it,
    ``events`` (the block's device events in start order, guard spins and
    user-annotation spans left out), ``wall_ms`` (the block's host time)
    and ``intact`` (both guards recorded)."""

    prof: Any = None
    events: List[Any] = dataclasses.field(default_factory=list)
    wall_ms: float = 0.0
    intact: bool = False


@contextlib.contextmanager
def guarded_profile():
    """Profile the block on the CPU and the GPU between guards (see
    ``GUARD_SPINS``); yields a :class:`GuardedProfile` that is filled in
    when the block ends.  Needs a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    out = GuardedProfile()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out.prof = prof
        time.sleep(SETTLE_S)
        for _ in range(GUARD_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield out
        out.wall_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        torch.cuda._sleep(10_000_000)
        for _ in range(GUARD_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
    device = sorted((ev for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and not ev.is_user_annotation), key=lambda ev: ev.time_range.start)
    out.intact = bool(device) and SENTINEL in device[0].name and SENTINEL in device[-1].name
    out.events = [ev for ev in device if SENTINEL not in ev.name]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``<log_dir>/trace.json`` (Chrome trace
    format).  Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` sums the block's time by operation and kernel.  Where
    a GPU is present the block runs between guards (:func:`guarded_profile`;
    the guard spins show in the trace as ``spin_kernel``), and a profile
    that did not keep both guards, and so may lack device events of the
    block, warns."""
    os.makedirs(log_dir, exist_ok=True)
    if torch.cuda.is_available():
        with guarded_profile() as g:
            yield g.prof
        if not g.intact:
            warnings.warn("torch.profiler lost device events at an end of the trace: "
                          "kernels of the block may be missing from it", RuntimeWarning,
                          stacklevel=3)
        prof = g.prof
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    """Wait for the GPU where the process has used it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kw) -> float:
    """Average seconds per call of ``fn(*args, **kw)`` on the host clock,
    after ``warmup`` calls; the device is synchronized after every call."""

    def run():
        out = fn(*args, **kw)
        _sync()
        return out

    for _ in range(warmup):
        run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters


def edges_per_sec(num_edges: int, message_passing_steps: int,
                  seconds_per_step: float) -> float:
    """Edges processed per second across all message-passing rounds."""
    return num_edges * message_passing_steps / max(seconds_per_step, 1e-12)


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Numerical-debug context: with ``nans``, autograd's anomaly detection
    (a backward that makes a NaN raises, naming the forward operation).
    ``disable_jit`` is accepted for the JAX package's signature and has no
    effect: the port runs eagerly."""
    del disable_jit
    with torch.autograd.set_detect_anomaly(nans):
        yield
