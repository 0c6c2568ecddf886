"""Does ``torch.profiler`` keep every device event of a profile taken late in a
process's life?

Every ``--every`` seconds for ``--minutes`` minutes this profiles 50 short
kernels (an in-place add on 1,024 floats) three ways and prints one JSON line:
the process's age and how many of the 50 device events each profile kept —
``kept``, the kernels alone; ``kept_after_settle``, launched after the
guards' host wait (``SETTLE_S``) alone; ``kept_between_guards``, under
:func:`mgn_tpu_torch.utils.profiling.guarded_profile`, the routine every
profile of ``chip_smoke.py`` and :func:`~mgn_tpu_torch.utils.profiling.trace`
use, with ``guards_intact`` where the profile's first and last device events
are guard spins.  Between samples the card runs spin kernels.

    python -m mgn_tpu_torch.probes.profiler_drift [--minutes 10] [--every 20]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from mgn_tpu_torch.utils.profiling import GUARD_SPINS, SETTLE_S, guarded_profile

KERNELS = 50


def _adds(x: torch.Tensor) -> None:
    for _ in range(KERNELS):
        x.add_(1.0)


def kept(x: torch.Tensor, settle: bool = False) -> int:
    """Device events recorded of one profile of ``KERNELS`` in-place adds,
    launched at once or after the guards' host wait."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if settle:
            time.sleep(SETTLE_S)
        _adds(x)
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.is_user_annotation)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mgn_tpu_torch.probes.profiler_drift",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--minutes", type=float, default=10.0)
    p.add_argument("--every", type=float, default=20.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_drift: needs a CUDA device")
    x = torch.ones(1024, device="cuda")
    t0 = time.time()
    while time.time() - t0 < a.minutes * 60:
        age = round(time.time() - t0, 1)
        with guarded_profile() as g:
            _adds(x)
        print(json.dumps({"age_s": age, "kernels": KERNELS, "kept": kept(x),
                          "kept_after_settle": kept(x, settle=True),
                          "kept_between_guards": len(g.events), "guards_intact": g.intact,
                          "settle_s": SETTLE_S, "guards": GUARD_SPINS,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
        t1 = time.time()
        while time.time() - t1 < a.every:
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
