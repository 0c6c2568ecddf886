#!/usr/bin/env python3
"""Drive the PyTorch port (mgn_tpu_torch) on one NVIDIA GPU and check it.

Phases, each fatal on failure:

1. build   — compile every CUDA kernel of the serving path from ops/csrc/
             (one nvcc per library, in parallel) and print the build time and
             ptxas' register/spill report;
2. K1      — the CSR segment-sum kernel against its plain PyTorch version at
             the cylinder shapes (E_pad 11,264, N_pad 1,920, F 128; f32 and
             bf16, trash row included) and on a 20k-node channel mesh;
3. K2, K3  — the edge- and node-stage kernels, one round each, and the whole
             processor (fused_process: 15 rounds of K2 -> K1 -> K3) against
             process_rounds_plain at latent 128, 2 hidden layers, f32 and
             bf16; one round on the 20k-node mesh;
4. K4, K5, K6, K1-perm — the backward kernels (edge and node stage
             reverses, weight gradients, the sender-side segment-sum) against
             their plain versions at the cylinder shapes, f32 and bf16; K4/K5
             also on the 20k-node mesh; K6 per MLP round (one grouped call)
             beside the index_select + torch.matmul route for the same round;
5. gradient — fused_process's gradients (15 rounds, every leaf, v0, e0)
             through the backward kernels against torch.autograd of
             process_rounds_plain on the card, f32 and bf16, and a second
             backward pass that must give the same bits; f32 also reported
             on four more seeds at 1 and 15 rounds, each gradient (kernels,
             plain path) also against an f64 autograd witness;
6. serving — mgn_tpu_torch.simulate, 20 Euler steps on the 1,900-node channel
             mesh with random weights from a seed and Online normalizers
             filled from a synthetic trajectory; the launch counters show the
             path went through K1, K2 and K3, and the result is held against
             the same simulate on the CPU (plain path);
7. training — mgn_tpu_torch.train_network on a synthetic channel-flow
             TFRecord dataset of the 1,900-node mesh (written by the port's
             writer): 40 steps at full width with two validation sweeps; the
             counters show every kernel ran; one frame's whole-model gradient
             and three noise-free steps are held against the CPU plain path;
             ms per training step and the device's idle share;
8. report  — per-kernel times, launches, errors and bounds as one JSON line,
             the card's name and power limit, and the final status line.

Run from the repository root:  python3 chip_smoke.py
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mgn_tpu_torch import (Args, MGNConfig, MetricsLogger, build_model_config, init_mgn,
                           simulate, train_network)
from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import build_template
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.prep import common_buckets, prepare_trajectory
from mgn_tpu_torch.data.synthetic import (make_channel_mesh, make_trajectory, synthetic_meta,
                                          write_synthetic_tfrecord_dataset)
from mgn_tpu_torch.models.mgn import apply_mgn
from mgn_tpu_torch.ops import _build
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_plain
from mgn_tpu_torch.train.common import (NormState, TrainState, assemble_graph, masked_mse,
                                        param_leaves, type_mask)
from mgn_tpu_torch.train.derivative import (DerivativeTrainerConfig, frame_inputs,
                                            make_derivative_trainer)

# H100 SXM data-sheet peaks: HBM bytes/s, and
# operations/s per type — f32 on the CUDA cores, bf16 on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the tensor-core rates K4 and K6 run at: bf16 directly, f32 as 3xTF32 (three
# TF32 products per f32 product, 495 TFLOP/s of TF32)
PEAK_TC_OPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
LATENT, HIDDEN, MPS, STEPS = 128, 2, 15, 20
TRAIN = dict(steps=40, norm_steps=10, checkpoint=20, tl=21)  # two 20-frame windows
DEVICE = "cuda"  # the training phase's device (a CPU rehearsal sets "cpu")
FORWARD = ("csr_segment_sum", "edge_round", "node_round")
KERNELS = {"csr_segment_sum": csr_segment_sum, "edge_round": F.edge_round,
           "node_round": F.node_round, "edge_round_bwd": F.edge_round_bwd,
           "node_round_bwd": F.node_round_bwd, "wgrad": F.wgrad}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    csr_segment_sum.perm_launches = 0


def read_counts() -> dict:
    counts = {name: k.launches for name, k in KERNELS.items()}
    counts["csr_segment_sum_perm"] = csr_segment_sum.perm_launches
    return counts


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per call from CUDA events around ``iters`` back-to-back calls.
    Where the host enqueues more slowly than the device runs (small kernels
    behind a Python wrapper) this is the host's rate, not the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def is_copy(name: str) -> bool:
    """A profiler device event that is a copy or a fill, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def device_time(fn, iters: int = 50, warmup: int = 5, match: str = "") -> tuple:
    """(device ms per call, device kernels per call): the summed duration of
    the GPU activity (kernels, copies) that torch.profiler records over
    ``iters`` calls, and the number of kernels among it, each divided by
    ``iters``; with ``match``, only activity whose name contains it (one
    wrapper's kernels, without the copies that reset its inputs).  Host-side
    launch cost is left out."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA and match in ev.name]
    total_us = sum(ev.time_range.elapsed_us() for ev in events)
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device activity: cannot time kernels")
    return total_us / 1e3 / iters, sum(not is_copy(ev.name) for ev in events) / iters


def device_ms(fn, iters: int = 50, warmup: int = 5, match: str = "") -> float:
    return device_time(fn, iters, warmup, match)[0]


def timings(fn, iters: int = 50) -> tuple:
    """(device ms per call, host-bound ms per call)."""
    return device_ms(fn, iters), time_ms(fn, iters)


def kernel_label(mangled: str) -> str:
    """A ptxas entry name as ``name<template arguments>``, e.g.
    ``edge_round_bwd_kernel<f32,128>``, from its mangled form."""
    m = re.search(r"([a-z_]+_kernel)(I.*?Ev)?", mangled)
    if m is None:
        return mangled
    args = re.sub(r"Li(\d+)E", r",\1", (m.group(2) or "")[1:-2].replace("13__nv_bfloat16",
                                                                      "bf16"))
    args = "f32" + args[1:] if args.startswith("f") else args
    return f"{m.group(1)}<{args.strip(',E')}>" if args else m.group(1)


def bound_ms(bytes_moved: float, ops: float, dtype, peaks=PEAK_OPS) -> tuple:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peaks[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def processor(seed: int):
    """Random processor weights (init_mgn) at the flagship width."""
    cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=LATENT,
                    hidden_layers=HIDDEN, message_passing_steps=MPS)
    return init_mgn(cfg, torch.Generator().manual_seed(seed), device="cuda")["processor"]


def cylinder(num_nodes: int = 1900):
    pos, cells, nt = make_channel_mesh(num_nodes, seed=0)
    return pos, cells, nt, build_template(pos, nt, cells=cells).to("cuda")


# --- phase 2: K1 ------------------------------------------------------------

def check_k1(t, dtype, gen, label):
    """K1 against the plain version; returns (max_abs_err, data)."""
    e_pad, n_pad = t.num_edges, t.num_nodes
    data = torch.randn((e_pad, LATENT), generator=gen, device="cuda").to(dtype)
    out = csr_segment_sum(data, t.receivers, t.row_offsets, n_pad)
    ref = csr_segment_sum_plain(data, t.receivers, t.row_offsets, n_pad)
    torch.cuda.synchronize()
    # both sum each row in f32, in different orders: the gap is at most
    # 2 (deg - 1) u sum|x| (u = 2^-24) per entry
    deg = torch.diff(t.row_offsets).float()[:, None]
    abs_sum = csr_segment_sum_plain(data.abs(), t.receivers, t.row_offsets, n_pad)
    bound = 2 * torch.clamp(deg - 1, min=0) * 2.0 ** -24 * abs_sum + 1e-30
    err = (out - ref).abs()
    if not (err <= bound).all():
        raise AssertionError(f"K1 {label}: {int((err > bound).sum())} entries beyond the "
                             f"summation bound, max_abs_err {float(err.max()):.3e}")
    if out[torch.diff(t.row_offsets) == 0].any():
        raise AssertionError(f"K1 {label}: an empty row is not zero")
    log(f"  K1 {label}: max_abs_err {float(err.max()):.3e} (bound: 2(deg-1)u sum|x|, "
        f"trash row degree {int(deg[-1])})")
    return float(err.max()), data


def phase_k1(t, t20k):
    log("phase K1")
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        err, data = check_k1(t, dtype, gen, f"cylinder {dtype}")
        e_pad, n_pad = t.num_edges, t.num_nodes
        ms, call_ms = timings(lambda: csr_segment_sum(data, t.receivers, t.row_offsets,
                                                      n_pad), 200)
        plain_ms, plain_call = timings(lambda: csr_segment_sum_plain(
            data, t.receivers, t.row_offsets, n_pad), 200)
        nbytes = e_pad * LATENT * data.element_size() + (n_pad + 1) * 4 + n_pad * LATENT * 4
        b_ms, b_by = bound_ms(nbytes, e_pad * LATENT, torch.float32)
        res[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, call_ms=call_ms, plain_call_ms=plain_call)
        log(f"  K1 {dtype}: device {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms "
            f"({b_by}); per call back to back {call_ms:.5f} ms, plain {plain_call:.5f} ms")
    data = torch.randn((t.num_edges, LATENT), generator=gen, device="cuda")
    offsets = t.row_offsets.long()
    lib_out = torch.segment_reduce(data, "sum", offsets=offsets, axis=0)
    ref = csr_segment_sum_plain(data, t.receivers, t.row_offsets, t.num_nodes)
    if not torch.allclose(lib_out, ref, rtol=1e-4, atol=1e-4):
        raise AssertionError("torch.segment_reduce does not compute the same sum")
    res[torch.float32]["library_ms"] = device_ms(
        lambda: torch.segment_reduce(data, "sum", offsets=offsets, axis=0), 200)
    log(f"  library torch.segment_reduce f32: device {res[torch.float32]['library_ms']:.5f} ms")
    check_k1(t20k, torch.float32, gen, f"20k-node mesh (N_pad {t20k.num_nodes}, "
                                       f"E_pad {t20k.num_edges}) f32")
    return res


# --- phase 3: K2, K3 and the processor ---------------------------------------

def processor_inputs(t, dtype, gen):
    n_pad, e_pad = t.num_nodes, t.num_edges
    ev = t.edge_mask.to(dtype)[:, None].contiguous()
    v0 = torch.randn((n_pad, LATENT), generator=gen, device="cuda").to(dtype)
    e0 = (torch.randn((e_pad, LATENT), generator=gen, device="cuda").to(dtype) * ev)
    return v0, e0.contiguous(), ev


def err_stats(out, ref):
    d = (out.float() - ref.float())
    return float(d.abs().max()), float(d.norm() / ref.float().norm())


# f32: the kernels and cuBLAS sum the products in other orders; 15 rounds of
# LayerNorm amplify the last-bit differences, so allow 1e-3 absolute on
# latents of magnitude up to ~30.  bf16: an order difference flips a bf16
# rounding now and then (2^-8 relative) and the flips propagate through the
# rounds, so hold the relative L2 error to 2e-2 instead.
TOL = {torch.float32: ("max_abs", 1e-3), torch.bfloat16: ("rel_l2", 2e-2)}


def check_tol(label, dtype, max_abs, rel_l2):
    kind, tol = TOL[dtype]
    val = max_abs if kind == "max_abs" else rel_l2
    log(f"  {label} {dtype}: max_abs_err {max_abs:.3e}, rel_l2 {rel_l2:.3e} "
        f"(tolerance {kind} <= {tol})")
    if not val <= tol:
        raise AssertionError(f"{label} {dtype}: {kind} {val:.3e} > {tol}")


def phase_processor(t, t20k, proc):
    log("phase K2/K3/processor")
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_pad, e_pad = t.num_nodes, t.num_edges
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        v0, e0, ev = processor_inputs(t, dtype, gen)
        em = F.cast_mlp(proc["edge_mlp"], dtype)
        nm = F.cast_mlp(proc["node_mlp"], dtype)
        em0, nm0 = F.round_params(em, 0), F.round_params(nm, 0)
        # K2, one round
        e_k = e0.clone()
        msg_k = F.edge_round(e_k, v0, t.senders, t.receivers, ev, em0)
        e_p, msg_p = F.edge_round_plain(e0, v0, t.senders, t.receivers, ev, em0)
        torch.cuda.synchronize()
        k2_err = err_stats(msg_k, msg_p)
        check_tol("K2 one round (msg)", dtype, *k2_err)
        check_tol("K2 one round (e)", dtype, *err_stats(e_k, e_p))
        if msg_k[~t.edge_mask].any():
            raise AssertionError("K2: a dead edge produced a message")
        # K3, one round, on the plain aggregate of the same messages
        agg = csr_segment_sum_plain(msg_p, t.receivers, t.row_offsets, n_pad)
        v_k = v0.clone()
        F.node_round(v_k, agg, nm0)
        v_p = F.node_round_plain(v0, agg, nm0)
        torch.cuda.synchronize()
        k3_err = err_stats(v_k, v_p)
        check_tol("K3 one round (v)", dtype, *k3_err)
        # the whole processor
        out = F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, MPS)
        ref = F.process_rounds_plain(proc, v0, e0, t.senders, t.receivers, ev, MPS, dtype,
                                     n_pad)
        torch.cuda.synchronize()
        check_tol(f"fused_process {MPS} rounds (v)", dtype, *err_stats(out, ref))

        e_t = e0.clone()
        k2_ms, k2_call = timings(lambda: F.edge_round(e_t, v0, t.senders, t.receivers, ev,
                                                      em0))
        k2_plain, _ = timings(lambda: F.edge_round_plain(e0, v0, t.senders, t.receivers, ev,
                                                         em0))
        v_t = v0.clone()
        k3_ms, k3_call = timings(lambda: F.node_round(v_t, agg, nm0))
        k3_plain, _ = timings(lambda: F.node_round_plain(v0, agg, nm0))
        fwd_ms, fwd_call = timings(lambda: F.fused_process(proc, v0, e0, t.senders,
                                                           t.receivers, t.row_offsets, ev,
                                                           MPS), 10)
        fwd_plain, fwd_plain_call = timings(lambda: F.process_rounds_plain(
            proc, v0, e0, t.senders, t.receivers, ev, MPS, dtype, n_pad), 10)
        b = torch.finfo(dtype).bits // 8
        w_e = (3 + HIDDEN) * LATENT * LATENT * b + (HIDDEN + 1) * LATENT * b + 2 * LATENT * 4
        w_n = (2 + HIDDEN) * LATENT * LATENT * b + (HIDDEN + 1) * LATENT * b + 2 * LATENT * 4
        k2_ops = 2 * e_pad * (3 + HIDDEN) * LATENT * LATENT
        k2_bytes = (3 * e_pad * LATENT + n_pad * LATENT + e_pad) * b + 2 * e_pad * 4 + w_e
        k3_ops = 2 * n_pad * (2 + HIDDEN) * LATENT * LATENT
        k3_bytes = 2 * n_pad * LATENT * b + n_pad * LATENT * 4 + w_n
        k2_b, k2_by = bound_ms(k2_bytes, k2_ops, dtype)
        k3_b, k3_by = bound_ms(k3_bytes, k3_ops, dtype)
        res[dtype] = {
            "edge_round": dict(max_abs_err=k2_err[0], ms=k2_ms, plain_ms=k2_plain,
                               bound_ms=k2_b, bound_by=k2_by, call_ms=k2_call),
            "node_round": dict(max_abs_err=k3_err[0], ms=k3_ms, plain_ms=k3_plain,
                               bound_ms=k3_b, bound_by=k3_by, call_ms=k3_call),
            "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain,
            "forward_call_ms": fwd_call, "forward_plain_call_ms": fwd_plain_call}
        log(f"  K2 {dtype}: device {k2_ms:.5f} ms, plain {k2_plain:.5f} ms, bound {k2_b:.5f} ms "
            f"({k2_by}, {k2_ops / 1e9:.3f} GFLOP); per call back to back {k2_call:.5f} ms")
        log(f"  K3 {dtype}: device {k3_ms:.5f} ms, plain {k3_plain:.5f} ms, bound {k3_b:.5f} ms "
            f"({k3_by}, {k3_ops / 1e9:.3f} GFLOP); per call back to back {k3_call:.5f} ms")
        log(f"  processor {MPS} rounds {dtype}: device {fwd_ms:.4f} ms (plain {fwd_plain:.4f}); "
            f"per call back to back {fwd_call:.4f} ms (plain {fwd_plain_call:.4f})")
    # P4: the same kernels on a mesh ten times larger, one round
    v0, e0, ev = processor_inputs(t20k, torch.float32, gen)
    out = F.fused_process(proc, v0, e0, t20k.senders, t20k.receivers, t20k.row_offsets, ev, 1)
    ref = F.process_rounds_plain(proc, v0, e0, t20k.senders, t20k.receivers, ev, 1,
                                 torch.float32, t20k.num_nodes)
    torch.cuda.synchronize()
    check_tol("fused_process 20k-node mesh, 1 round (v)", torch.float32, *err_stats(out, ref))
    return res


# --- phase 4: the backward kernels -----------------------------------------------

# Tolerances of one backward round against its plain version.  f32: at
# least 99.9 % of the entries within 1e-4 x (|ref| + max(1, max |ref|)), and
# relative L2 <= 1e-3.  The kernels and cuBLAS sum in other orders; where a
# ReLU's pre-activation lies within rounding of 0 the two take different
# sides and that row's cotangent moves by O(1) (one such row in a round of
# the 20k-node mesh, 31 million ReLU decisions).  bf16: a flipped bf16
# rounding now and then, so relative L2 <= 2e-2.
def check_bwd(label, dtype, out, ref):
    out, ref = out.float(), ref.float()
    max_abs = float((out - ref).abs().max())
    rel = float((out - ref).norm()) / max(float(ref.norm()), 1e-30)
    if dtype == torch.float32:
        scale = max(1.0, float(ref.abs().max()))
        share = float(((out - ref).abs() > 1e-4 * (ref.abs() + scale)).float().mean())
        ok, what = share <= 1e-3 and rel <= 1e-3, f"share outside 1e-4 {share:.2e} <= 1e-3"
    else:
        ok, what = rel <= 2e-2, "rel_l2 <= 2e-2"
    if not ok:
        raise AssertionError(f"{label} {dtype}: max_abs_err {max_abs:.3e}, rel_l2 {rel:.3e} "
                             f"(tolerance {what}, rel_l2 <= 1e-3)")
    return max_abs, rel


def check_saved(label, dtype, saved, ref) -> float:
    errs = [check_bwd(f"{label} dh[{i}]", dtype, a, b)[0] for i, (a, b) in
            enumerate(zip(saved.dh, ref.dh))]
    errs += [check_bwd(f"{label} post[{i}]", dtype, a, b)[0] for i, (a, b) in
             enumerate(zip(saved.post, ref.post))]
    errs.append(check_bwd(f"{label} LayerNorm partial sums", dtype, saved.ln, ref.ln)[0])
    return max(errs)


def weight_bytes(parts: int, b: int) -> int:
    """One round's MLP: forward weights and their transposes, biases, LN."""
    return 2 * (parts + HIDDEN) * LATENT * LATENT * b + (HIDDEN + 1) * LATENT * b + 2 * LATENT * 4


def bwd_inputs(t, dtype, gen, proc):
    v0, e0, ev = processor_inputs(t, dtype, gen)
    rnd = lambda rows: torch.randn((rows, LATENT), generator=gen, device="cuda").to(dtype)
    em = F.round_params(F.cast_mlp(proc["edge_mlp"], dtype), 0)
    nm = F.round_params(F.cast_mlp(proc["node_mlp"], dtype), 0)
    return dict(v0=v0, e0=e0, ev=ev, agg=rnd(t.num_nodes), dv=rnd(t.num_nodes),
                de=rnd(t.num_edges), em=em, nm=nm,
                emt=[w.t().contiguous() for w in em["w"]],
                nmt=[w.t().contiguous() for w in nm["w"]])


def wgrad_library(saved, inputs):
    """The gradients of one MLP round from one PyTorch call each
    (index_select, torch.matmul, sum), in the order of mlp_wgrads' outputs:
    every dW, every db, then the LayerNorm [scale | bias] gradients.  A
    yardstick for K6; the port never calls it."""
    dh = [d.float() for d in saved.dh]
    xs = [(x if idx is None else x.index_select(0, idx)).float() for x, idx in inputs]
    dws = [torch.cat([torch.matmul(x.t(), dh[0]) for x in xs])]
    dws += [torch.matmul(saved.post[i - 1].float().t(), dh[i]) for i in range(1, len(dh))]
    return dws + [d.sum(0) for d in dh] + [saved.ln.sum(0)]


def relu_input_errors(t, x, saved):
    """K4's recomputed ReLU outputs and those of its plain version (cuBLAS),
    each as relative L2 distance to the same forward in f64."""
    d = lambda a: a.double()
    w = x["em"]["w"]
    h = (d(x["e0"]) @ d(w[0][:LATENT]) + d(x["v0"])[t.senders.long()] @ d(w[0][LATENT:2 * LATENT])
         + d(x["v0"])[t.receivers.long()] @ d(w[0][2 * LATENT:]) + d(x["em"]["b"][0]))
    errs = []
    for i in range(1, len(w)):
        h = torch.relu(h)
        errs.append(float((d(saved.post[i - 1]) - h).norm() / h.norm()))
        h = h @ d(w[i]) + d(x["em"]["b"][i])
    return errs


def run_bwd_round(t, x, dtype, label):
    """K5 then K4 on one round against their plain versions; returns the
    errors and the plain outputs."""
    dv = x["dv"].clone()
    dagg, saved_n = F.node_round_bwd(dv, x["v0"], x["agg"], x["nm"], x["nmt"])
    ref_dv, ref_dagg, ref_n = F.node_round_bwd_plain(x["dv"], x["v0"], x["agg"], x["nm"])
    de = x["de"].clone()
    dvs, dvr, saved_e = F.edge_round_bwd(de, ref_dagg, x["e0"], x["v0"], t.senders,
                                         t.receivers, x["ev"], x["em"], x["emt"])
    ref_de, ref_dvs, ref_dvr, ref_e = F.edge_round_bwd_plain(
        x["de"], ref_dagg, x["e0"], x["v0"], t.senders, t.receivers, x["ev"], x["em"])
    torch.cuda.synchronize()
    k5 = max(check_bwd(f"K5 {label} dv", dtype, dv, ref_dv)[0],
             check_bwd(f"K5 {label} dagg", dtype, dagg, ref_dagg)[0],
             check_saved(f"K5 {label}", dtype, saved_n, ref_n))
    k4 = max(check_bwd(f"K4 {label} de", dtype, de, ref_de)[0],
             check_bwd(f"K4 {label} dvs", dtype, dvs, ref_dvs)[0],
             check_bwd(f"K4 {label} dvr", dtype, dvr, ref_dvr)[0],
             check_saved(f"K4 {label}", dtype, saved_e, ref_e))
    if dvs[~t.edge_mask].any() or dvr[~t.edge_mask].any():
        raise AssertionError("K4: a dead edge produced a gradient")
    log(f"  K5 {label} {dtype}: max_abs_err {k5:.3e}; K4: max_abs_err {k4:.3e} "
        "(tolerance: see check_bwd)")
    if dtype == torch.float32:
        log(f"  K4 {label} recomputed ReLU outputs, relative L2 to an f64 forward: kernel "
            f"{relu_input_errors(t, x, saved_e)}, plain version (cuBLAS f32) "
            f"{relu_input_errors(t, x, ref_e)}")
    return k4, k5, ref_dvs, ref_e


def phase_backward(t, t20k, proc):
    log("phase K4/K5/K6/K1-perm")
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_pad, e_pad, L = t.num_nodes, t.num_edges, LATENT
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        b = torch.finfo(dtype).bits // 8
        x = bwd_inputs(t, dtype, gen, proc)
        k4_err, k5_err, dvs, saved_e = run_bwd_round(t, x, dtype, "cylinder")
        # K1 with the sender permutation, on the plain dvs
        out = csr_segment_sum(dvs, t.senders, t.sender_offsets, n_pad, perm=t.sender_perm)
        ref = csr_segment_sum_plain(dvs, t.senders, t.sender_offsets, n_pad, perm=t.sender_perm)
        torch.cuda.synchronize()
        deg = torch.diff(t.sender_offsets).float()[:, None]
        bound = 2 * torch.clamp(deg - 1, min=0) * 2.0 ** -24 * csr_segment_sum_plain(
            dvs.abs(), t.senders, t.sender_offsets, n_pad, perm=t.sender_perm) + 1e-30
        perm_err = (out - ref).abs()
        if not (perm_err <= bound).all():
            raise AssertionError(f"K1-perm {dtype}: beyond the summation bound, max_abs_err "
                                 f"{float(perm_err.max()):.3e}")
        # K6 at its largest call: the edge MLP's first layer, e part, with the bias
        dh0 = saved_e.dh[0]
        dw, db = torch.empty((L, L), device="cuda"), torch.empty((L,), device="cuda")
        F.wgrad(dh0, x["e0"], None, dw=dw, db=db)
        ref_w, ref_b = F.wgrad_plain(dh0, x["e0"])
        dws = torch.empty((L, L), device="cuda")  # the sender part, through a gather
        F.wgrad(dh0, x["v0"], t.senders, dw=dws)
        ref_ws, _ = F.wgrad_plain(dh0, x["v0"], t.senders)
        torch.cuda.synchronize()
        k6_err = max(check_bwd("K6 dW0 (e part)", torch.float32, dw, ref_w)[0],
                     check_bwd("K6 db0", torch.float32, db, ref_b)[0],
                     check_bwd("K6 dW0 (sender part)", torch.float32, dws, ref_ws)[0])
        log(f"  K1-perm {dtype}: max_abs_err {float(perm_err.max()):.3e} (within "
            f"2(deg-1)u sum|x|); K6 {dtype}: max_abs_err {k6_err:.3e}")

        # times at the cylinder shapes (the copies that reset the carries are
        # left out of the kernels' device time by name)
        # device kernels per wrapper call (kpc) counted from the same profiles
        k5_ms, k5_kpc = device_time(lambda: F.node_round_bwd(
            x["dv"].clone(), x["v0"], x["agg"], x["nm"], x["nmt"]), match="node_round_bwd")
        k5_plain = device_ms(lambda: F.node_round_bwd_plain(x["dv"], x["v0"], x["agg"], x["nm"]))
        k4_ms, k4_kpc = device_time(lambda: F.edge_round_bwd(x["de"].clone(), ref_b.new_zeros(
            (n_pad, L)), x["e0"], x["v0"], t.senders, t.receivers, x["ev"], x["em"], x["emt"]),
            match="edge_round_bwd")
        zeros_agg = torch.zeros((n_pad, L), device="cuda")
        k4_plain = device_ms(lambda: F.edge_round_bwd_plain(
            x["de"], zeros_agg, x["e0"], x["v0"], t.senders, t.receivers, x["ev"], x["em"]))
        perm_ms, perm_kpc = device_time(lambda: csr_segment_sum(
            dvs, t.senders, t.sender_offsets, n_pad, perm=t.sender_perm), 200,
            match="csr_segment_sum")
        perm_plain = device_ms(lambda: csr_segment_sum_plain(
            dvs, t.senders, t.sender_offsets, n_pad, perm=t.sender_perm), 200)
        k6_ms, k6_kpc = device_time(lambda: F.wgrad(dh0, x["e0"], None, dw=dw, db=db), 200,
                                    match="wgrad")
        k6_plain = device_ms(lambda: F.wgrad_plain(dh0, x["e0"]), 200)
        # K6 over one round: one grouped call per MLP (every layer, bias and
        # LayerNorm gradient), beside the library route for the same round
        grads = {m: {"w": [torch.zeros((1,) + tuple(w.shape), device="cuda")
                           for w in x[k]["w"]],
                     "b": [torch.zeros((1, L), device="cuda") for _ in x[k]["w"]],
                     "ln_scale": torch.zeros((1, L), device="cuda"),
                     "ln_bias": torch.zeros((1, L), device="cuda")}
                 for m, k in (("edge", "em"), ("node", "nm"))}
        _, _, saved_n = F.node_round_bwd_plain(x["dv"], x["v0"], x["agg"], x["nm"])
        edge_in = [(x["e0"], None), (x["v0"], t.senders), (x["v0"], t.receivers)]
        node_in = [(x["v0"], None), (x["agg"], None)]
        rounds = {"edge": (saved_e, edge_in), "node": (saved_n, node_in)}
        k6r = {}
        for m, (saved, inputs) in rounds.items():
            before = F.wgrad.launches
            F.mlp_wgrads(saved, inputs, grads[m], 0)
            if F.wgrad.launches != before + 1:
                raise AssertionError("mlp_wgrads is not one grouped K6 call")
            ref = wgrad_library(saved, inputs)
            torch.cuda.synchronize()
            got = [g[0] for g in grads[m]["w"]] + [g[0] for g in grads[m]["b"]] + [
                torch.cat([grads[m]["ln_scale"][0], grads[m]["ln_bias"][0]])]
            k6r[f"{m}_max_abs_err"] = max(check_bwd(f"K6 {m} round {i}", torch.float32, a, b)[0]
                                          for i, (a, b) in enumerate(zip(got, ref)))
            k6r[f"{m}_ms"], k6r[f"{m}_kernels_per_call"] = device_time(
                lambda: F.mlp_wgrads(saved, inputs, grads[m], 0), 50, match="wgrad")
            if dtype == torch.float32:
                k6r[f"{m}_library_ms"] = device_ms(lambda: wgrad_library(saved, inputs), 50)
        lib = {}
        if dtype == torch.float32:
            idx = t.senders.long()
            zero = torch.zeros((n_pad, L), device="cuda")
            lib["perm"] = device_ms(lambda: zero.index_add(0, idx, dvs), 200)
            lib["wgrad"] = device_ms(lambda: torch.matmul(x["e0"].t(), dh0), 200)
        # bounds: each input read once, each output written once; operations
        # 2 (3 + H) L^2 MACs per edge (recompute + adjoint), as FLOP
        k4_ops = 2 * 2 * (3 + HIDDEN) * L * L * e_pad
        k4_bytes = ((2 * e_pad * L + n_pad * L + e_pad) * b + n_pad * L * 4 + 2 * e_pad * 4
                    + weight_bytes(3, b)
                    + (3 + HIDDEN + 1 + HIDDEN) * e_pad * L * b
                    + -(-e_pad // F._EDGE_BWD_ROWS) * 2 * L * 4)
        k5_ops = 2 * 2 * (2 + HIDDEN) * L * L * n_pad
        k5_bytes = (3 * n_pad * L * b + weight_bytes(2, b)
                    + (1 + HIDDEN + 1 + HIDDEN) * n_pad * L * b + n_pad * L * 4
                    + (n_pad // 2) * 2 * L * 4)
        perm_bytes = e_pad * L * b + e_pad * 4 + (n_pad + 1) * 4 + n_pad * L * 4
        k6_ops = 2 * e_pad * L * L + e_pad * L
        k6_bytes = 2 * e_pad * L * b + (L * L + L) * 4
        # K6 per round: dh_0..dh_H and the ReLU outputs, the first layer's
        # inputs (v once for both gathers), the indices and LayerNorm partial
        # sums read; every gradient written
        out_bytes = lambda parts: ((parts + HIDDEN) * L * L + (HIDDEN + 3) * L) * 4
        k6r_bytes = ((2 * HIDDEN + 1) * (e_pad + n_pad) * L * b + (e_pad + 3 * n_pad) * L * b
                     + 2 * e_pad * 4 + (saved_e.ln.numel() + saved_n.ln.numel()) * 4
                     + out_bytes(3) + out_bytes(2))
        k6r_ops = (2 * e_pad * (3 + HIDDEN) * L * L + 2 * n_pad * (2 + HIDDEN) * L * L)
        entries = {
            "edge_round_bwd": (k4_err, k4_ms, k4_plain, *bound_ms(k4_bytes, k4_ops, dtype), None,
                               k4_kpc),
            "node_round_bwd": (k5_err, k5_ms, k5_plain, *bound_ms(k5_bytes, k5_ops, dtype), None,
                               k5_kpc),
            "csr_segment_sum_perm": (float(perm_err.max()), perm_ms, perm_plain,
                                     *bound_ms(perm_bytes, e_pad * L, torch.float32),
                                     lib.get("perm"), perm_kpc),
            "wgrad": (k6_err, k6_ms, k6_plain, *bound_ms(k6_bytes, k6_ops, torch.float32),
                      lib.get("wgrad"), k6_kpc),
        }
        res[dtype] = {k: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "device_launches_per_call"), v))
                      for k, v in entries.items()}
        # the same bounds at the tensor-core rate of the units K4 and K6 use
        for name, nbytes, ops, dt in (("edge_round_bwd", k4_bytes, k4_ops, dtype),
                                      ("wgrad", k6_bytes, k6_ops, dtype)):
            res[dtype][name]["bound_tc_ms"], res[dtype][name]["bound_tc_by"] = bound_ms(
                nbytes, ops, dt, PEAK_TC_OPS)
        k6r_bound = bound_ms(k6r_bytes, k6r_ops, torch.float32)
        k6r_tc = bound_ms(k6r_bytes, k6r_ops, dtype, PEAK_TC_OPS)
        res[dtype]["wgrad_round"] = dict(
            ms=k6r["edge_ms"] + k6r["node_ms"], calls=2, **k6r,
            library_ms=(k6r["edge_library_ms"] + k6r["node_library_ms"]
                        if dtype == torch.float32 else None),
            bound_ms=k6r_bound[0], bound_by=k6r_bound[1], bound_tc_ms=k6r_tc[0],
            bound_tc_by=k6r_tc[1], gflop=k6r_ops / 1e9, mbytes=k6r_bytes / 1e6)
        for name, r in res[dtype].items():
            if name != "wgrad_round":
                log(f"  {name} {dtype}: device {r['ms']:.5f} ms ("
                    f"{r['device_launches_per_call']:g} device kernels a call), plain "
                    f"{r['plain_ms']:.5f} ms, "
                    f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}"
                    + (f"; tensor cores {r['bound_tc_ms']:.5f} ms, {r['bound_tc_by']}"
                       if "bound_tc_ms" in r else "") + f"), library {r['library_ms']}")
        w = res[dtype]["wgrad_round"]
        log(f"  K6 over one round (2 grouped calls: edge {w['edge_ms']:.5f} ms, node "
            f"{w['node_ms']:.5f} ms; device kernels a call: edge {w['edge_kernels_per_call']:g}, "
            f"node {w['node_kernels_per_call']:g}) {dtype}: device {w['ms']:.5f} ms, library route "
            f"{w['library_ms']}, bound {w['bound_ms']:.5f} ms ({w['bound_by']}; tensor cores "
            f"{w['bound_tc_ms']:.5f} ms, {w['bound_tc_by']}; {w['gflop']:.3f} GFLOP, "
            f"{w['mbytes']:.1f} MB)")
        if dtype == torch.float32 and not w["ms"] < w["library_ms"]:
            log("  note: K6 per round is not below the library route in this run")
    # P6: the same kernels on a mesh ten times larger
    x = bwd_inputs(t20k, torch.float32, gen, proc)
    run_bwd_round(t20k, x, torch.float32, f"20k-node mesh (E_pad {t20k.num_edges})")
    return res


# --- phase 5: the processor's gradient ---------------------------------------------

def grad_copy(tree, device=None, dtype=None):
    """A detached copy on ``device`` (in ``dtype``) of a nested parameter
    dict whose leaves need a gradient."""
    if isinstance(tree, dict):
        return {k: grad_copy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [grad_copy(v, device, dtype) for v in tree]
    return tree.detach().to(device or DEVICE, dtype, copy=True).requires_grad_(True)


def grad_stats(got, ref):
    """Per-leaf (share of entries outside rtol/atol 5e-4 of the leaf's scale,
    relative L2, max |Δ|), and the worst of each over the leaves."""
    stats = []
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        scale = max(1.0, float(b.abs().max()))
        bad = float(((a - b).abs() > 5e-4 * (b.abs() + scale)).float().mean())
        rel = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        stats.append((bad, rel, float((a - b).abs().max())))
    return [max(s[i] for s in stats) for i in range(3)]


# Whole-gradient tolerance.  f32: at most 1 % of a leaf's entries outside
# rtol 5e-4 and atol 5e-4 x max(1, max |ref|), and relative L2 <= 2e-3.
# Where a ReLU pre-activation lies within rounding of 0 the kernels' and
# cuBLAS's summation orders take different sides and move that row's
# cotangent by O(1); each earlier round spreads it to the neighbouring rows
# (0.12 % of the entries of the worst leaf over 15 rounds at the cylinder
# size, relative L2 4.8e-4).  bf16: relative L2 <= 0.25 — over 15 rounds two
# bf16 paths drift apart by about 10 % (the plain path's autograd rounds
# weight gradients to bf16 and sums scatter cotangents in bf16) — and, what
# decides, check_bf16_accuracy.
def check_grads(label, dtype, got, ref):
    bad, rel, max_abs = grad_stats(got, ref)
    if dtype == torch.float32:
        ok, what = bad <= 1e-2 and rel <= 2e-3, "share outside 5e-4 <= 1e-2, rel_l2 <= 2e-3"
    else:
        ok, what = rel <= 0.25, "rel_l2 <= 0.25"
    log(f"  {label} {dtype}: worst leaf: share outside rtol/atol 5e-4 {bad:.2e}, rel_l2 "
        f"{rel:.3e}, max_abs_err {max_abs:.3e} (tolerance {what})")
    if not ok:
        raise AssertionError(f"{label} {dtype}: {bad:.2e} outside, rel_l2 {rel:.3e}")
    return dict(share_outside=bad, rel_l2=rel, max_abs_err=max_abs)


def check_bf16_accuracy(label, got, ref, truth):
    """bf16 gradients against the f32 gradient at the same (bf16-valued)
    inputs: per leaf, the kernels' relative L2 error must be at most 1.25x
    that of torch.autograd's bf16 path, plus 1e-3."""
    rel = lambda a, b: float((a.float() - b.float()).norm()) / max(float(b.float().norm()), 1e-30)
    errs = [(rel(a, c), rel(b, c)) for a, b, c in zip(got, ref, truth)]
    worst_k, worst_a = max(e[0] for e in errs), max(e[1] for e in errs)
    log(f"  {label} bf16 against the f32 gradient: worst leaf relative L2, kernels "
        f"{worst_k:.3e}, autograd of the plain path {worst_a:.3e} (tolerance: kernels <= "
        f"1.25x autograd + 1e-3, per leaf)")
    for i, (k, a) in enumerate(errs):
        if not k <= 1.25 * a + 1e-3:
            raise AssertionError(f"{label} bf16 leaf {i}: relative L2 to the f32 gradient "
                                 f"{k:.3e} against autograd's {a:.3e}")
    return dict(kernels_vs_f32=worst_k, autograd_vs_f32=worst_a)


def phase_processor_grad(t, proc):
    log("phase processor gradient")
    gen = torch.Generator(device="cuda").manual_seed(6)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        v0, e0, ev = processor_inputs(t, dtype, gen)
        p = grad_copy(proc)
        leaves = param_leaves(p)
        v0.requires_grad_(True)
        e0.requires_grad_(True)

        def kernels():
            out = F.fused_process(p, v0, e0, t.senders, t.receivers, t.row_offsets, ev, MPS,
                                  sender_perm=t.sender_perm, sender_offsets=t.sender_offsets)
            return torch.autograd.grad((out.float() ** 2).sum(), [v0, e0, *leaves])

        def plain():
            out = F.process_rounds_plain(p, v0, e0, t.senders, t.receivers, ev, MPS, dtype,
                                         t.num_nodes)
            return torch.autograd.grad((out.float() ** 2).sum(), [v0, e0, *leaves])

        reset_counts()
        got = kernels()
        counts = read_counts()
        if counts["edge_round_bwd"] != MPS or counts["node_round_bwd"] != MPS:
            raise AssertionError(f"the gradient did not run the backward kernels: {counts}")
        again = kernels()  # fixed-order sums only: the same bits on every pass
        ref = plain()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"  two backward passes {dtype}: gradients bit-identical {same}")
        if not same:
            raise AssertionError(f"two backward passes gave different gradients ({dtype})")
        if got[1][~t.edge_mask].any():
            raise AssertionError("a dead edge's latent got a gradient")
        res[dtype] = check_grads(f"fused_process gradient, {MPS} rounds", dtype, got, ref)
        res[dtype]["bit_identical"] = same
        if dtype == torch.bfloat16:
            p32 = grad_copy(proc)
            v32 = v0.detach().float().requires_grad_(True)
            e32 = e0.detach().float().requires_grad_(True)
            out32 = F.fused_process(p32, v32, e32, t.senders, t.receivers, t.row_offsets,
                                    ev.float(), MPS, sender_perm=t.sender_perm,
                                    sender_offsets=t.sender_offsets)
            truth = torch.autograd.grad((out32 ** 2).sum(), [v32, e32, *param_leaves(p32)])
            res[dtype].update(check_bf16_accuracy(f"fused_process gradient, {MPS} rounds",
                                                  got, ref, truth))
        res[dtype]["ms"] = device_ms(kernels, 10)
        res[dtype]["plain_ms"] = device_ms(plain, 10)
        res[dtype]["call_ms"] = time_ms(kernels, 10)
        log(f"  forward + backward {dtype}: device {res[dtype]['ms']:.4f} ms (plain autograd "
            f"{res[dtype]['plain_ms']:.4f}); per call back to back {res[dtype]['call_ms']:.4f} ms; "
            f"launches per gradient {counts}")
    res["f64_witness"] = [gradient_accuracy(t, seed, mps) for mps in (1, MPS)
                          for seed in ACCURACY_SEEDS]
    return res


def process_rounds_f64(proc, v0, e0, t, mps: int):
    """The processor rounds in f64 from plain ops, rounded to no compute
    dtype: the witness that measures each f32 gradient's own error."""
    s, r = t.senders.long(), t.receivers.long()
    ev = t.edge_mask.double()[:, None]

    def mlp(m, parts, k):
        h = torch.cat(parts, dim=-1) @ m["w"][0][k] + m["b"][0][k]
        for i in range(1, len(m["w"])):
            h = torch.relu(h) @ m["w"][i][k] + m["b"][i][k]
        return torch.nn.functional.layer_norm(h, h.shape[-1:], m["ln_scale"][k],
                                              m["ln_bias"][k], 1e-5)

    v, e = v0, e0
    for k in range(mps):
        msg = mlp(proc["edge_mlp"], [e, v[s], v[r]], k) * ev
        e = e + msg
        v = v + mlp(proc["node_mlp"], [v, torch.zeros_like(v).index_add(0, r, msg)], k)
    return v


# f32 gradients checked on these further seeds (weights and inputs), each
# also against the f64 witness, at 1 round and at MPS rounds
ACCURACY_SEEDS = (7, 8, 9, 10)


def gradient_accuracy(t, seed: int, mps: int) -> dict:
    """One f32 gradient of ``mps`` processor rounds at weights and inputs
    from ``seed``, as distances (worst leaf) between: the kernels and
    autograd of process_rounds_plain; each of the two and autograd of
    process_rounds_f64; and the plain path and a second run of itself, whose
    scatter-adds (atomics) sum in another order — the distance that the
    summation order alone makes through ReLU ties.  Reported, with whether
    the kernels are within the whole-gradient tolerance of the plain path;
    the fatal check is phase_processor_grad's (section 6 of PERF.md)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    proc = processor(seed)
    v0, e0, ev = processor_inputs(t, torch.float32, gen)
    grads = {}
    for path in ("kernels", "plain", "plain_again", "f64"):
        dt = torch.float64 if path == "f64" else torch.float32
        p = grad_copy(proc, dtype=dt)
        v, e = (x.detach().to(dt).requires_grad_(True) for x in (v0, e0))
        if path == "kernels":
            out = F.fused_process(p, v, e, t.senders, t.receivers, t.row_offsets, ev, mps,
                                  sender_perm=t.sender_perm, sender_offsets=t.sender_offsets)
        elif path == "f64":
            out = process_rounds_f64(p, v, e, t, mps)
        else:
            out = F.process_rounds_plain(p, v, e, t.senders, t.receivers, ev, mps,
                                         torch.float32, t.num_nodes)
        grads[path] = torch.autograd.grad((out ** 2).sum(), [v, e, *param_leaves(p)])
    res = {}
    for path, ref in (("kernels", "plain"), ("kernels", "f64"), ("plain", "f64"),
                      ("plain", "plain_again")):
        bad, rel, max_abs = grad_stats(grads[path], grads[ref])
        res[f"{path}_vs_{ref}"] = dict(share_outside=bad, rel_l2=rel, max_abs_err=max_abs,
                                       median_err=median_error(grads[path], grads[ref]))
    kp = res["kernels_vs_plain"]
    within = kp["share_outside"] <= 1e-2 and kp["rel_l2"] <= 2e-3  # check_grads' f32 tolerance
    log(f"  f32 gradient, {mps} rounds, seed {seed}, worst leaf relative L2 (median error): "
        + "; ".join(f"{k.replace('_vs_', ' vs ')} {r['rel_l2']:.3e} ({r['median_err']:.3e})"
                    for k, r in res.items())
        + f"; kernels vs plain share outside 5e-4 {kp['share_outside']:.2e}, within the "
        f"whole-gradient tolerance {within}")
    return dict(seed=seed, rounds=mps, within_tolerance=within, **res)


def median_error(got, ref) -> float:
    """Worst leaf's median |Δ| over the RMS of the reference leaf: the error
    of the bulk of the entries, where relative L2 is set by the few rows
    that a flipped ReLU decision moves most."""
    out = 0.0
    for a, b in zip(got, ref):
        d = (a.double() - b.double()).abs().flatten()
        rms = float(b.double().square().mean().sqrt())
        out = max(out, float(d.median()) / max(rms, 1e-30))
    return out


# --- phase 7: training ---------------------------------------------------------------

def frame_loss_grads(params, norm, prep, t: int, cfg, spec):
    """One frame's loss and whole-model gradient, noise 0, normalizers as
    given (no accumulation): the trainer's loss on the trainer's inputs."""
    tcfg = DerivativeTrainerConfig(cfg, spec, (0.0,))
    tm = prep.template
    with torch.no_grad():
        noisy = type_mask(tm.node_type, tcfg.types_noisy) & tm.node_mask
        gen = torch.Generator(device=prep.times.device).manual_seed(0)
        u, raw = frame_inputs(tcfg, prep.fields, prep.times, t, noisy, gen)
        target = torch.cat([norm.output[f](raw[f]) for f in spec.target_fields], dim=-1)
        graph = assemble_graph(norm, tm, u, spec)
    pred = apply_mgn(params, graph, cfg, tm.row_offsets, tm.sender_perm, tm.sender_offsets)
    loss = masked_mse(pred, target, type_mask(tm.node_type, tcfg.types_updated) & tm.node_mask)
    return loss, torch.autograd.grad(loss, param_leaves(params))


def to_cpu_prep(prep):
    return type(prep)(prep.template.to("cpu"), {k: v.cpu() for k, v in prep.fields.items()},
                      prep.times.cpu(), prep.num_nodes, prep.num_steps)


def profile_training(trainer, state, prep, perm, gen) -> dict:
    """Device time by kernel and the device's idle share over a few training
    steps, from torch.profiler's CUDA activity (the profiler's host cost is
    in the wall time, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    names = ("edge_round_bwd", "node_round_bwd", "wgrad", "edge_round", "node_round",
             "csr_segment_sum")
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer(state, prep.template, prep.fields, prep.times, perm, gen)
        wall_ms = (time.perf_counter() - t0) * 1e3
    calls = read_counts()
    calls["csr_segment_sum"] += calls.pop("csr_segment_sum_perm")  # one kernel serves both
    groups = {k: 0.0 for k in names + ("other",)}
    kernels = dict.fromkeys(names, 0)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for k in names if k in ev.name), "other")
        groups[key] += ev.time_range.elapsed_us() / 1e3
        if key != "other" and not is_copy(ev.name):
            kernels[key] += 1
    busy = sum(groups.values())
    if busy == 0.0:
        log("  profile: the profiler recorded no device activity; device time not measured")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    n = len(perm)
    per_call = {k: kernels[k] / calls[k] if calls[k] else None for k in names}
    log(f"  profile of {n} training steps: wall {wall_ms / n:.3f} ms per step (profiler on), "
        f"device busy {busy / n:.3f} ms per step, idle share {1 - busy / wall_ms:.4f}; by "
        "kernel (ms per step): " + ", ".join(f"{k} {v / n:.3f} ({v / busy:.3f})"
                                             for k, v in groups.items()))
    log("  device kernels per step (per wrapper call), counted by the profiler: "
        + ", ".join(f"{k} {kernels[k] / n:g} ({per_call[k]})" for k in names))
    return {"wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy / n,
            "idle_share": 1 - busy / wall_ms, "device_ms_per_step": {k: v / n for k, v in
                                                                   groups.items()},
            "device_kernels_per_step": {k: kernels[k] / n for k in names},
            "device_kernels_per_call": per_call}


def phase_training(workdir):
    log("phase training")
    ds, cp = os.path.join(workdir, "ds"), os.path.join(workdir, "cp_train")
    t0 = time.perf_counter()
    write_synthetic_tfrecord_dataset(ds, num_nodes=1900, tl=TRAIN["tl"], n_train=2, n_valid=1,
                                     n_test=0, seed=0)
    log(f"  wrote a 1,900-node channel-flow TFRecord dataset (2 train + 1 valid trajectories "
        f"of {TRAIN['tl']} frames) in {time.perf_counter() - t0:.2f} s")
    model = dict(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN)
    metrics = MetricsLogger(quiet=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, best = train_network(0.02, lambda ps: torch.optim.Adam(ps, lr=1e-4), ds, cp,
                                metrics=metrics, device=DEVICE, steps=TRAIN["steps"],
                                norm_steps=TRAIN["norm_steps"], checkpoint=TRAIN["checkpoint"],
                                solver_valid="euler", seed=0, **model)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    train = [r for r in metrics.records if r["kind"] == "train"]
    valid = [r for r in metrics.records if r["kind"] == "valid"]
    log(f"  train_network: {state.step} steps ({TRAIN['norm_steps']} of warm-up), "
        f"{len(valid)} validation sweeps, {wall_s:.2f} s in all; window losses "
        f"{[round(r['loss'], 6) for r in train]}, validation losses "
        f"{[round(r['loss'], 6) for r in valid]}; peak device memory {peak_mb:.1f} MiB")
    log(f"  launches in train_network: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by train_network")
    if state.step != TRAIN["steps"] or len(valid) != 2 or not all(
            np.isfinite(r["loss"]) for r in train + valid):
        raise AssertionError(f"training did not run as set up: step {state.step}, "
                             f"{len(valid)} validation sweeps, losses {train + valid}")

    # ms per training step, on one prepared trajectory, past the warm-up
    dataset = load_dataset(ds)
    meta = dataset.meta
    cfg, spec = build_model_config(meta, Args(**model))
    nb, eb = common_buckets([dataset.structure(0)], meta, 128, 512)
    prep = prepare_trajectory(dataset.trajectory(0), meta, spec, nb, eb, device=DEVICE)
    trainer = make_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.02,), norm_steps=0))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    perm = list(range(TRAIN["tl"] - 1))
    trainer(state, prep.template, prep.fields, prep.times, perm[:2], gen)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer(state, prep.template, prep.fields, prep.times, perm, gen)  # returns host losses
    step_ms = (time.perf_counter() - t0) * 1e3 / len(perm)
    per_step = {k: v / len(perm) for k, v in read_counts().items()}
    if per_step["wgrad"] != 2 * MPS:  # one grouped K6 call per MLP round
        raise AssertionError(f"{per_step['wgrad']} K6 calls per training step, "
                             f"expected {2 * MPS}")
    step_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    residual_mb = MPS * (2 * prep.template.num_nodes + prep.template.num_edges) * LATENT * 4 / 1e6
    log(f"  training step (forward + backward + Adam, noise 0.02): {step_ms:.3f} ms per step "
        f"over {len(perm)} steps; peak device memory {step_peak_mb:.1f} MiB; residual stacks "
        f"{residual_mb:.1f} MB per step; wrapper calls per step {per_step}")
    profile = profile_training(trainer, state, prep, perm[:5], gen)
    if profile.get("device_kernels_per_step"):
        log(f"  K6 per training step: {per_step['wgrad']:.0f} wrapper calls, "
            f"{profile['device_kernels_per_step']['wgrad']:g} device kernels")

    # one frame's whole-model gradient: the card against the CPU plain path
    prep_cpu = to_cpu_prep(prep)
    loss_g, g_gpu = frame_loss_grads(grad_copy(state.params), state.norm, prep, 3, cfg, spec)
    loss_c, g_cpu = frame_loss_grads(grad_copy(state.params, "cpu"), state.norm.to("cpu"),
                                     prep_cpu, 3, cfg, spec)
    log(f"  one frame's loss: {DEVICE} {float(loss_g.detach()):.7f}, cpu "
        f"{float(loss_c.detach()):.7f}")
    grad_check = check_grads("whole-model gradient, cuda vs cpu plain path", torch.float32,
                             [g.cpu() for g in g_gpu], g_cpu)

    # three noise-free steps from the same state on both devices
    steps, frames = [], [0, (TRAIN["tl"] - 1) // 3, 2 * (TRAIN["tl"] - 1) // 3]
    for dev, prep_d in ((DEVICE, prep), ("cpu", prep_cpu)):
        p = grad_copy(state.params, dev)
        st = TrainState(p, torch.optim.Adam(param_leaves(p), lr=1e-4), state.norm.to(dev), 0)
        tr = make_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.0,), norm_steps=0))
        _, losses = tr(st, prep_d.template, prep_d.fields, prep_d.times, frames,
                       torch.Generator(device=dev).manual_seed(0))
        steps.append(losses.numpy())
    rel = float(np.max(np.abs(steps[0] - steps[1]) / np.abs(steps[1])))
    log(f"  3 noise-free steps: cuda losses {steps[0].tolist()}, cpu {steps[1].tolist()}, "
        f"max relative difference {rel:.3e} (tolerance 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"training steps on cuda differ from the cpu path by {rel:.3e}")
    return launches, per_step, dict(wall_s=wall_s, steps=TRAIN["steps"], peak_mib=peak_mb,
                          ms_per_step=step_ms, step_peak_mib=step_peak_mb,
                          residual_mb=residual_mb, profile=profile, grad_check=grad_check,
                          step_losses_rel_diff=rel, window_losses=[r["loss"] for r in train],
                          valid_losses=[r["loss"] for r in valid])


# --- phase 6: serving ----------------------------------------------------------

def online_from(x: np.ndarray, max_acc: float) -> N.Online:
    """Online accumulators filled from data rows, as training leaves them."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return N.Online(acc_count=f(1.0), num_accumulations=f(len(x)), acc_sum=f(x.sum(0)),
                    acc_sum_sq=f((x * x).sum(0)), max_acc=f(max_acc), std_epsilon=f(1e-8))


def phase_serving(workdir):
    log("phase serving")
    dt = 0.01
    meta = synthetic_meta(tl=STEPS + 1, n_train=1, n_valid=1, dt=dt)
    with open(os.path.join(workdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    pos, cells, nt = make_channel_mesh(1900, seed=0)
    vel = make_trajectory(pos, nt, tl=STEPS + 1, dt=dt, seed=1)
    args = Args(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN)
    cfg, _ = build_model_config(meta, args)
    params = init_mgn(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, _, n_norms, _ = N.normalizers_from_meta(meta, args.max_norm_steps)
    tmpl = build_template(pos, nt, cells=cells)
    n_norms["velocity"] = online_from(vel, args.max_norm_steps)
    norm = NormState(
        edge=online_from(tmpl.mesh_edge_features[tmpl.edge_mask].numpy(), args.max_norm_steps),
        node=n_norms, output={"velocity": online_from(np.diff(vel, axis=0) / dt,
                                                      args.max_norm_steps)})
    cp = os.path.join(workdir, "cp")
    CheckpointManager(cp).save(TrainState(params, None, norm, 0), loss=0.0)
    times = (np.arange(STEPS + 1) * dt).astype(np.float32)
    call = dict(meta_dir=workdir, cp_path=cp, mesh_pos=pos, node_type=nt,
                initial_fields={"velocity": vel[0]}, times=times, cells=cells,
                mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN)

    reset_counts()
    t0 = time.perf_counter()
    pred = simulate(**call)
    first_s = time.perf_counter() - t0
    launches = {name: read_counts()[name] for name in FORWARD}
    log(f"  simulate: {STEPS} Euler steps in {first_s:.4f} s (first call); launches {launches}")
    if pred.shape != (STEPS + 1, len(pos), 2) or not np.isfinite(pred).all():
        raise AssertionError(f"simulate returned shape {pred.shape}, finite "
                             f"{bool(np.isfinite(pred).all())}")
    for name, n in launches.items():
        if n < STEPS * MPS:
            raise AssertionError(f"{name} launched {n} times, expected >= {STEPS * MPS}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        simulate(**call)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    e_real = int(tmpl.edge_mask.sum())
    log(f"  simulate: median of 3 calls {wall:.4f} s = {wall / STEPS * 1e3:.3f} ms per Euler "
        f"step, {e_real * MPS * STEPS / wall:.4e} edge-updates/s (E = {e_real}, mps = {MPS}); "
        f"calls {[round(w, 4) for w in walls]}")
    profile = profile_serving(call)
    ref = simulate(**call, device="cpu")
    err = float(np.abs(pred - ref).max())
    log(f"  simulate cuda vs cpu (plain path): max_abs_err {err:.3e} (tolerance 1e-3; "
        f"|u| up to {float(np.abs(ref).max()):.3f})")
    if not err <= 1e-3:
        raise AssertionError(f"simulate on cuda differs from the cpu path by {err:.3e}")
    if not np.abs(pred[-1] - pred[0]).max() > 1e-3:
        raise AssertionError("simulate: the state did not evolve")
    return launches, dict(first_s=first_s, wall_s=wall, ms_per_step=wall / STEPS * 1e3,
                          edge_updates_per_s=e_real * MPS * STEPS / wall, profile=profile)


def profile_serving(call) -> dict:
    """Device time by kernel and the device's idle share over one simulate
    call, from torch.profiler's CUDA activity (the profiler's own host cost
    is in the wall time, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate(**call)
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"edge_round": 0.0, "csr_segment_sum": 0.0, "node_round": 0.0, "other": 0.0}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for k in groups if k != "other" and k in ev.name), "other")
        groups[key] += ev.time_range.elapsed_us() / 1e3
    busy = sum(groups.values())
    if busy == 0.0:
        log("  profile: the profiler recorded no device activity; device time not measured")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    log(f"  profile of one simulate call: wall {wall_ms:.3f} ms (profiler on), device busy "
        f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}; by kernel (ms): "
        + ", ".join(f"{k} {v:.3f} ({v / busy:.3f})" for k, v in groups.items()))
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "device_ms": groups}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase build")
    t0 = time.perf_counter()
    info = _build.build_all()
    log(f"  built {sorted(info)} in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, i in sorted(info.items()):
        kernel = ""
        for line in i["log"].splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {kernel}: {line.split(':', 1)[-1].strip()}")

    pos, cells, nt, t = cylinder()
    *_, t20k = cylinder(20000)
    log(f"cylinder mesh: N {len(pos)} (N_pad {t.num_nodes}), E {int(t.edge_mask.sum())} "
        f"(E_pad {t.num_edges}), max real in-degree "
        f"{int(torch.diff(t.row_offsets)[:-1].max())}, trash-row edges "
        f"{int(torch.diff(t.row_offsets)[-1])}")
    k1 = phase_k1(t, t20k)
    proc = processor(3)
    with torch.no_grad():
        proc_res = phase_processor(t, t20k, proc)
    bwd = phase_backward(t, t20k, proc)
    grad = phase_processor_grad(t, proc)
    with tempfile.TemporaryDirectory() as workdir:
        launches, serving = phase_serving(workdir)
        train_launches, per_step, training = phase_training(workdir)

    f32, bf16 = torch.float32, torch.bfloat16
    fwd_src, bwd_src = ("mgn_tpu_torch/ops/csrc/fused_round.cu",
                        "mgn_tpu_torch/ops/csrc/fused_round_bwd.cu")
    # name -> (source, TPU kernel it replaces, launches on its path, f32 results);
    # the forward kernels count the serving run, the backward ones the training run
    sources = {
        "csr_segment_sum": ("mgn_tpu_torch/ops/csrc/csr_segment.cu",
                            "mgn_tpu/ops/pallas_segment.py:122", launches, k1[f32]),
        "edge_round": (fwd_src, "mgn_tpu/ops/fused.py:469", launches,
                       proc_res[f32]["edge_round"]),
        "node_round": (fwd_src, "mgn_tpu/ops/fused.py:553", launches,
                       proc_res[f32]["node_round"]),
        "edge_round_bwd": (bwd_src, "mgn_tpu/ops/fused.py:888", train_launches,
                           bwd[f32]["edge_round_bwd"]),
        "node_round_bwd": (bwd_src, "mgn_tpu/ops/fused.py:855", train_launches,
                           bwd[f32]["node_round_bwd"]),
        "wgrad": ("mgn_tpu_torch/ops/csrc/wgrad.cu", "mgn_tpu/ops/fused.py:288",
                  train_launches, bwd[f32]["wgrad"]),
        "csr_segment_sum_perm": ("mgn_tpu_torch/ops/csrc/csr_segment.cu",
                                 "mgn_tpu/ops/fused.py:1036", train_launches,
                                 bwd[f32]["csr_segment_sum_perm"]),
    }
    # the counters count wrapper calls; the device kernels each call made in
    # the profiled training steps (K1 and K1-perm share one kernel)
    per_call = training["profile"].get("device_kernels_per_call") or {}
    kernels = []
    for name, (src, replaces, counts, r) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name], "launches_per_training_step": per_step[name],
                        "device_launches_per_call": per_call.get(name.replace("_perm", "")),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        **{k: r[k] for k in ("bound_tc_ms", "bound_tc_by") if k in r}})
    log("bf16: " + json.dumps({
        "csr_segment_sum": k1[bf16],
        **{k: proc_res[bf16][k] for k in ("edge_round", "node_round")},
        **{k: v for k, v in proc_res[bf16].items() if k.startswith("forward")},
        **{k: v for k, v in bwd[bf16].items()}}))
    log("f32 processor forward: " + json.dumps(
        {k: v for k, v in proc_res[f32].items() if k.startswith("forward")}))
    log("K6 per round: " + json.dumps({str(k): v["wgrad_round"] for k, v in bwd.items()}))
    log("processor gradient: " + json.dumps({str(k): v for k, v in grad.items()}))
    log("serving: " + json.dumps(serving))
    log("training launches: " + json.dumps(train_launches))
    log("training: " + json.dumps(training))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
