"""P8's counterpart: K10's one-hot gather and scatter for the TPU probe's
eight pairs of one-hot and value types.

``benchmarks/probe_onehot_dtype_tpu.py`` times, on the TPU, a kernel shaped
like the fused kernel's gather (``oh^T . band``) and scatter (``oh . msg``)
at its shipped sizes (band 512, chunk 1024, latent 128) over 200 rounds,
for eight (one-hot type, value type) pairs.  Hopper has no tensor-core
instruction that pairs s8 or e4m3 with bf16, or anything with f32, and the
one-hot is exact in every type, so the pairs fall onto three routes of K10
(``ops.onehot.onehot_pair``) by value type: bf16 values on bf16
``mma.sync``, f32 values on 3xTF32, and int8 x int8 on s8 ``mma.sync``.

The record keeps the TPU probe's keys (``us_per_round``, ``tflops``,
``max_abs_diff_vs_bf16``, ``speedup_vs_bf16``) and adds ``device`` (the card
and its power limit), ``route`` per variant, ``bound_us``, the least time of
one round of the function on an H100 (the larger of the bytes, each input
read and the output written once, and its f32 adds on the CUDA cores), and
``bound_tc_us``, the least time of the one-hot products at the route's
tensor-core rate.  The eight variants share three routes, so variants of
one route report one output and one time.
``tflops`` counts the port's own work, ``2 L band (band + chunk)`` a round:
the gather of the ``band`` rows that reach the output and the scatter.  The
TPU probe counted ``4 band chunk L`` (a ``chunk``-row gather).  Run on the
card::

    python -m mgn_tpu_torch.probes.onehot_dtype [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device
from mgn_tpu_torch.ops.onehot import make_pair_inputs, onehot_pair
from mgn_tpu_torch.probes import PEAK_BYTES, PEAK_F32, card, interleaved_ms

__all__ = ["VARIANTS", "ROUTES", "inputs", "run", "main"]

# name -> (one-hot type, value type), the TPU probe's names and order
VARIANTS = {"bf16": ("bf16", "bf16"), "f32": ("f32", "f32"), "int8_mixed": ("int8", "bf16"),
            "fp8_mixed": ("fp8_e4m3", "bf16"), "f32oh_bf16val": ("f32", "bf16"),
            "fp8oh_f32val": ("fp8_e4m3", "f32"), "bf16oh_f32val": ("bf16", "f32"),
            "int8_int8": ("int8", "int8")}
# value type -> K10's route on the card, and the route's rate (H100 SXM)
ROUTES = {"bf16": "bf16 mma.sync m16n8k16", "f32": "3xTF32 mma.sync m16n8k8",
          "int8": "s8 mma.sync m16n8k32, s32 sums"}
PEAK = {"bf16": 989e12, "f32": 495e12 / 3, "int8": 1979e12}
FLOPS_NOTE = ("2 L band (band + chunk) a round: the one-hot gather of the band rows that "
              "reach the output and the scatter; the TPU probe counts 4 band chunk L "
              "(a chunk-row gather)")


def inputs(band: int, chunk: int, latent: int, seed: int):
    """``(rel, band_v, msg)`` as the TPU probe draws them, in its order."""
    rng = np.random.default_rng(seed)
    rel = rng.integers(0, band, chunk).astype(np.int32)
    band_v = rng.standard_normal((band, latent)).astype(np.float32)
    msg = rng.standard_normal((chunk, latent)).astype(np.float32)
    return rel, band_v, msg


def run(band: int = 512, chunk: int = 1024, rounds: int = 200, latent: int = 128,
        iters: int = 10, passes: int = 8, device=None, seed: int = 0) -> dict:
    """The probe's record.  The eight variants are three computations, one
    per route: each route runs and is timed once and its variants share its
    output and time.  Each route's ``iters`` launches are timed together,
    ``passes`` times in turn with the other routes, and the least kept.
    ``device=None`` is the card (raises without one); on the CPU the record
    has the outputs and no timing.  ``record["outputs"]`` maps each variant
    to its f32 ``(band, latent)`` result."""
    dev = resolve_device(device)
    pair = make_pair_inputs(*inputs(band, chunk, latent, seed), dev)
    calls = {value: (lambda value=value: onehot_pair(pair, rounds, value)) for value in ROUTES}
    by_route = {value: fn() for value, fn in calls.items()}
    outputs = {name: by_route[value] for name, (_, value) in VARIANTS.items()}
    flops = 2 * latent * band * (band + chunk)
    record = {"backend": dev.type, "device": card() if dev.type == "cuda" else None,
              "shape": {"band": band, "chunk": chunk, "latent": latent}, "rounds": rounds,
              "seed": seed, "flops_per_round": flops, "flops_note": FLOPS_NOTE, "variants": {}}
    for name, (one_hot, value) in VARIANTS.items():
        rec = {"one_hot": one_hot, "value": value, "route": ROUTES[value]}
        if name != "bf16" and value != "int8":
            rec["max_abs_diff_vs_bf16"] = float((outputs[name] - outputs["bf16"]).abs().max())
        record["variants"][name] = rec
    if dev.type == "cuda":
        record["iters"], record["passes"] = iters, passes
        best = interleaved_ms(calls, iters, passes, counted=(onehot_pair,))
        # the function's bound a round: each input read and the output written
        # once, and its f32 adds (the gather's and the scatter's rows, and the
        # round's sum into the output)
        nbytes = 4 * (chunk + band * latent + chunk * latent + band * latent)
        t_bytes = nbytes / rounds / PEAK_BYTES
        t_adds = (2 * band + chunk) * latent / PEAK_F32
        for name, (_, value) in VARIANTS.items():
            us = best[value] * 1e3 / (iters * rounds)
            record["variants"][name].update(
                us_per_round=us, ms_per_call=best[value] / iters, tflops=flops / us / 1e6,
                bound_us=max(t_adds, t_bytes) * 1e6,
                bound_by="operations" if t_adds > t_bytes else "bytes",
                bound_tc_us=flops / PEAK[value] * 1e6)
        base = record["variants"]["bf16"]["us_per_round"]
        for rec in record["variants"].values():
            rec["speedup_vs_bf16"] = base / rec["us_per_round"]
    record["outputs"] = outputs
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--band", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--latent", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--passes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default=None, help="also write the record to this file")
    a = ap.parse_args(argv)
    record = run(a.band, a.chunk, a.rounds, a.latent, a.iters, a.passes, a.device, a.seed)
    record.pop("outputs")
    line = json.dumps(record)
    print(line)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
