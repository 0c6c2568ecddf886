"""P7's counterpart: K9's row gathers from banded windows, one-hot product
against direct reads, f32 and bf16.

``benchmarks/probe_dyngather_tpu.py`` times, on the TPU, the fused kernel's
``(chunk, L)`` row gathers from a banded window, ``chunks`` of them a round
for ``rounds`` rounds in one kernel: as a one-hot MXU product (``onehot``)
or as Mosaic's ``dynamic_gather`` (``dyn``), each with f32 and bf16 values.
Its defaults are the cylinder's gather shape: chunks x chunk = 11 x 1024 =
the cylinder's padded edge count, a window of 384 rows, 2048 rows of ``v``
(at least the cylinder's 1,920 padded nodes), latent 128.  Here the same
work runs through K9 (``ops.onehot.window_gather``): ``onehot`` on the
tensor cores, ``dyn_*`` as the ``direct`` variant, the GPU's own row
gather.  Two faults of the TPU probe are not copied (ROADMAP C10, C11): the
kernel's sum starts from zero, and every variant reads the same ``v``,
drawn once and cast for each type, so ``rel_err_vs_onehot_f32`` compares
like with like.

The record keeps the TPU probe's keys (``us_per_gather``, ``ms_total``,
``rel_err_vs_onehot_f32``) and adds ``device`` (the card and its power
limit) and per variant ``bound_us``, the least time of one gather of the
function on an H100: the larger of its bytes (``v``, ``rel`` and ``out``
once, over the rounds x chunks gathers) and its f32 adds.  ``bound_tc_us``
is the ``onehot`` variant's one-hot product at the tensor cores' rate for
the value type (f32 as 3xTF32), and ``l2_mb`` the ``direct`` variant's row
traffic from L2 a call.  Run on the card::

    python -m mgn_tpu_torch.probes.dyngather [--out FILE]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device
from mgn_tpu_torch.ops.onehot import make_window, window_gather
from mgn_tpu_torch.probes import PEAK_BYTES, PEAK_F32, card, interleaved_ms

__all__ = ["COMBOS", "inputs", "run", "main"]

# name -> (K9 variant, value type), the TPU probe's order and names
COMBOS = {"onehot_f32": ("onehot", torch.float32), "onehot_bf16": ("onehot", torch.bfloat16),
          "dyn_f32": ("direct", torch.float32), "dyn_bf16": ("direct", torch.bfloat16)}
PEAK_TC = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}  # f32 as 3xTF32


def inputs(chunk: int, band: int, chunks: int, n: int, latent: int, seed: int):
    """``(rel, starts, v)`` as the TPU probe draws them: banded relative
    indices around the window's middle, chunk starts spread over ``v`` and
    aligned to 32 rows, and one f32 ``v``."""
    rng = np.random.default_rng(seed)
    rel = np.minimum(np.maximum(rng.normal(band // 2, band // 6, size=(chunks, chunk)), 0),
                     band - 1).astype(np.int32)
    starts = (np.arange(chunks) * ((n - chunk) // max(chunks - 1, 1))).astype(np.int32)
    starts = (starts // 32) * 32
    v = rng.normal(size=(n, latent)).astype(np.float32)
    return rel, starts, v


def _bound(dtype, chunk: int, band: int, chunks: int, rounds: int, n: int,
           latent: int) -> tuple:
    """(ms, "bytes" or "operations") of one call of the function on an H100:
    ``v``, ``rel``, ``starts`` read and ``out`` written once, against the
    f32 adds of the rounds x chunks gathers.  Both variants compute this
    function."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = n * latent * itemsize + chunks * chunk * 4 + chunks * 4 + chunk * latent * 4
    t_ops = chunk * latent * chunks * rounds / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def run(chunk: int = 1024, band: int = 384, chunks: int = 11, rounds: int = 15,
        latent: int = 128, n: int = 2048, only: Optional[str] = None,
        iters: int = 50, passes: int = 3, device=None, seed: int = 0) -> dict:
    """The probe's record.  ``only``: the variants to run, names of
    :data:`COMBOS` separated by commas (default: all four).  ``iters``
    launches are timed together, ``passes`` times in turn with the other
    variants, and the least kept.  ``device=None`` is the card (raises
    without one); on the CPU the record has the outputs and no timing.
    ``record["outputs"]`` maps each variant to its f32 ``(chunk, latent)``
    result."""
    dev = resolve_device(device)
    names = list(COMBOS)
    if only:
        wanted = only.split(",")
        unknown = set(wanted) - set(COMBOS)
        if unknown:
            raise ValueError(f"unknown variants {sorted(unknown)}; choose from {names}")
        names = [name for name in names if name in wanted]
    rel, starts, v = inputs(chunk, band, chunks, n, latent, seed)
    win = make_window(rel, starts, band, dev)
    v32 = torch.from_numpy(v).to(dev)
    values = {torch.float32: v32, torch.bfloat16: v32.to(torch.bfloat16)}
    calls = {name: (lambda variant=variant, dtype=dtype:
                    window_gather(values[dtype], win, rounds, variant))
             for name, (variant, dtype) in ((k, COMBOS[k]) for k in names)}
    outputs = {name: fn() for name, fn in calls.items()}
    record = {"backend": dev.type, "device": card() if dev.type == "cuda" else None,
              "chunk": chunk, "band": band, "chunks": chunks, "rounds": rounds,
              "latent": latent, "n": n, "seed": seed}
    ref = outputs.get("onehot_f32")
    if ref is not None:
        scale = float(ref.abs().max())
        record["rel_err_vs_onehot_f32"] = {
            name: float((out - ref).abs().max()) / scale
            for name, out in outputs.items() if name != "onehot_f32"}
    for name in names:
        variant, dtype = COMBOS[name]
        record[name] = {"variant": variant, "dtype": str(dtype).replace("torch.", "")}
    if dev.type == "cuda":
        record["iters"], record["passes"] = iters, passes
        best = interleaved_ms(calls, iters, passes, counted=(window_gather,))
        gathers = rounds * chunks
        for name in names:
            variant, dtype = COMBOS[name]
            b_ms, b_by = _bound(dtype, chunk, band, chunks, rounds, n, latent)
            rec = record[name]
            rec.update(us_per_gather=best[name] * 1e3 / (iters * gathers),
                       ms_total=best[name], ms_per_call=best[name] / iters,
                       bound_us=b_ms * 1e3 / gathers, bound_ms_per_call=b_ms, bound_by=b_by)
            if variant == "onehot":
                tc_ms = 2 * chunk * band * latent * gathers / PEAK_TC[dtype] * 1e3
                rec.update(bound_tc_us=tc_ms * 1e3 / gathers, bound_tc_ms_per_call=tc_ms)
            if variant == "direct":
                rec["l2_mb"] = gathers * chunk * latent * (torch.finfo(dtype).bits // 8) / 1e6
    record["outputs"] = outputs
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--band", type=int, default=384)
    ap.add_argument("--chunks", type=int, default=11)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--latent", type=int, default=128)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--only", default=None, help="comma-separated variants")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default=None, help="also write the record to this file")
    a = ap.parse_args(argv)
    record = run(a.chunk, a.band, a.chunks, a.rounds, a.latent, a.n, a.only, a.iters, a.passes,
                 a.device, a.seed)
    record.pop("outputs")
    line = json.dumps(record)
    print(line)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
