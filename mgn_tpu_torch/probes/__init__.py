"""The port's counterparts of the JAX package's two TPU probes of the fused
kernel's gathers: :mod:`.dyngather` (``benchmarks/probe_dyngather_tpu.py``,
K9) and :mod:`.onehot_dtype` (``benchmarks/probe_onehot_dtype_tpu.py``,
K10).  Each ``run()`` returns its record as a dict; on the card it times the
kernels with CUDA events, on the CPU (``device="cpu"``) it returns the plain
versions' outputs and no timing.  ``python -m mgn_tpu_torch.probes.<name>``
prints the record as one JSON line.  :mod:`.profiler_drift` checks the
measuring tool itself: how many device events ``torch.profiler`` keeps in
a profile taken late in a process's life.
"""

from __future__ import annotations

import math
import subprocess
from typing import Callable, Dict, Sequence

import torch

__all__ = ["PEAK_BYTES", "PEAK_F32", "card", "interleaved_ms"]

PEAK_BYTES = 3.35e12  # H100 SXM device memory, bytes/s
PEAK_F32 = 67e12  # H100 SXM f32 on the CUDA cores, operations/s


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def interleaved_ms(calls: Dict[str, Callable[[], object]], iters: int, passes: int,
                   counted: Sequence[Callable] = (), warmup: int = 3) -> Dict[str, float]:
    """Device ms of ``iters`` back-to-back calls of each function, the least
    over ``passes`` passes that take the functions in turn: the card's rate
    drifts between calls, and interleaving keeps the drift out of the
    comparison.  Each function's ``iters`` calls are captured once into a
    CUDA graph and each pass replays it between two CUDA events, so the time
    is the device's and not the host's launch rate (the TPU probes loop
    inside one jit for the same reason).  ``counted``: the wrappers whose
    ``launches`` the calls move.  A capture runs nothing on the card and a
    replay launches every kernel the capture recorded, so the counters are
    set back after the capture and each replay adds what the capture added:
    they hold the launches the card made."""
    for fn in calls.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    graphs, recorded = {}, {}
    for name, fn in calls.items():
        before = [w.launches for w in counted]
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
        recorded[name] = [w.launches - b for w, b in zip(counted, before)]
        for w, b in zip(counted, before):
            w.launches = b
    torch.cuda.synchronize()
    best = {name: math.inf for name in calls}
    for _ in range(passes):
        for name, graph in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best[name] = min(best[name], start.elapsed_time(end))
            for w, n in zip(counted, recorded[name]):
                w.launches += n
    return best
