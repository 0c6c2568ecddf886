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
4. serving — mgn_tpu_torch.simulate, 20 Euler steps on the 1,900-node channel
             mesh with random weights from a seed and Online normalizers
             filled from a synthetic trajectory; the launch counters show the
             path went through K1, K2 and K3, and the result is held against
             the same simulate on the CPU (plain path);
5. report  — per-kernel times, launches, errors and bounds as one JSON line,
             the card's name and power limit, and the final status line.

Run from the repository root:  python3 chip_smoke.py
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mgn_tpu_torch import Args, MGNConfig, build_model_config, init_mgn, simulate
from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import build_template
from mgn_tpu_torch.data.synthetic import make_channel_mesh, make_trajectory, synthetic_meta
from mgn_tpu_torch.ops import _build
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_plain
from mgn_tpu_torch.train.common import NormState

# H100 SXM data-sheet peaks: HBM bytes/s, and
# operations/s per type — f32 on the CUDA cores, bf16 on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
LATENT, HIDDEN, MPS, STEPS = 128, 2, 15, 20
KERNELS = {"csr_segment_sum": csr_segment_sum, "edge_round": F.edge_round,
           "node_round": F.node_round}


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


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time per call: the summed duration of the GPU activity
    (kernels, copies) that torch.profiler records over ``iters`` calls,
    divided by ``iters``.  Host-side launch cost is left out."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device activity: cannot time kernels")
    return total_us / 1e3 / iters


def timings(fn, iters: int = 50) -> tuple:
    """(device ms per call, host-bound ms per call)."""
    return device_ms(fn, iters), time_ms(fn, iters)


def bound_ms(bytes_moved: float, ops: float, dtype) -> tuple:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


# --- phase 4: serving ----------------------------------------------------------

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
    CheckpointManager(cp).save(params, norm, step=0, loss=0.0)
    times = (np.arange(STEPS + 1) * dt).astype(np.float32)
    call = dict(meta_dir=workdir, cp_path=cp, mesh_pos=pos, node_type=nt,
                initial_fields={"velocity": vel[0]}, times=times, cells=cells,
                mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN)

    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    pred = simulate(**call)
    first_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
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
        for line in i["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    pos, cells, nt, t = cylinder()
    *_, t20k = cylinder(20000)
    log(f"cylinder mesh: N {len(pos)} (N_pad {t.num_nodes}), E {int(t.edge_mask.sum())} "
        f"(E_pad {t.num_edges}), max real in-degree "
        f"{int(torch.diff(t.row_offsets)[:-1].max())}, trash-row edges "
        f"{int(torch.diff(t.row_offsets)[-1])}")
    k1 = phase_k1(t, t20k)
    proc = init_mgn(MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2,
                              latent_size=LATENT, hidden_layers=HIDDEN,
                              message_passing_steps=MPS),
                    torch.Generator().manual_seed(3), device="cuda")["processor"]
    with torch.no_grad():
        proc_res = phase_processor(t, t20k, proc)
    with tempfile.TemporaryDirectory() as workdir:
        launches, serving = phase_serving(workdir)

    f32 = torch.float32
    sources = {"csr_segment_sum": ("mgn_tpu_torch/ops/csrc/csr_segment.cu",
                                   "mgn_tpu/ops/pallas_segment.py:122", k1[f32]),
               "edge_round": ("mgn_tpu_torch/ops/csrc/fused_round.cu",
                              "mgn_tpu/ops/fused.py:469", proc_res[f32]["edge_round"]),
               "node_round": ("mgn_tpu_torch/ops/csrc/fused_round.cu",
                              "mgn_tpu/ops/fused.py:553", proc_res[f32]["node_round"])}
    kernels = []
    for name, (src, replaces, r) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    log("bf16: " + json.dumps({
        "csr_segment_sum": k1[torch.bfloat16],
        **{k: proc_res[torch.bfloat16][k] for k in ("edge_round", "node_round")},
        **{k: v for k, v in proc_res[torch.bfloat16].items() if k.startswith("forward")}}))
    log("f32 processor forward: " + json.dumps(
        {k: v for k, v in proc_res[f32].items() if k.startswith("forward")}))
    log("serving: " + json.dumps(serving))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
