#!/usr/bin/env python3
"""Drive the PyTorch port (mgn_tpu_torch) on one NVIDIA GPU and check it.

Phases, each fatal on failure:

1. build   — compile every CUDA kernel of the serving path from ops/csrc/
             (one nvcc per library, in parallel) and print the build time and
             ptxas' register/spill report;
1b. probes — K9 (window_gather, the counterpart of the TPU probe P7) in its
             four variants (one-hot tensor-core product and direct row reads,
             f32 and bf16) at P7's defaults, bit for bit against its plain
             version, with one embedding_bag as the library route; K10
             (onehot_pair, P8's counterpart) on its three routes (bf16, 3xTF32,
             s8), onto which P8's eight variants fall, against its plain
             version (int8 bitwise, the others within 1e-6 of max |ref|); both
             probes' run() on the card (mgn_tpu_torch.probes.dyngather and
             .onehot_dtype), whose launches the report counts, the CUDA
             graph replays that time them included; K9's direct
             variant on the cylinder's edge index (K2's P[s], Q[r] gathers),
             reported beside K2's time;
2. K1      — the CSR segment-sum kernel, in both forms (K1 and K1-perm), f32
             and bf16, bit for bit against its plain PyTorch version run on
             the CPU copy of the same inputs (both sum in K1's fixed chunk
             order) and a second call the same bits: the cylinder's, the
             flag's and the 20k-node mesh's templates, a CSR with rows of 0,
             1, C - 1, C, C + 1, 2C + 1 and 5,000 entries at widths 32, 128
             and 256, csr_order's output with a valid mask whose left-out
             rows are NaN; then against the summation bound of the card's
             plain version at the cylinder shapes (E_pad 11,264, N_pad 1,920,
             F 128; trash row included) and on a 20k-node channel mesh;
3. K7      — the first layer's projections (edge_project: P = v W0[L:2L],
             Q = v W0[2L:3L], f32) against edge_project_plain at the
             cylinder's, the flag's and the 20k-node mesh's node counts, f32
             and bf16, two calls giving the same bits;
   K2, K3  — the edge- and node-stage kernels, one round each (K2 on the
             plain projections, and the control: K2 with Q zeroed must fail
             K2's check), the weight-stream layout kernel of all three
             streams (bit for bit), and the whole processor (fused_process:
             one weight-stream launch, then 15 rounds of K7 -> K2 -> K1 ->
             K3, counted by the profiler) against process_rounds_plain in
             its pre-projected and its three-part form at latent 128, 2
             hidden layers, f32 and bf16; one round on the 20k-node mesh;
3b. streams — the weight-stream layout kernel (stream_tile.cuh) bit for bit
             against weight_streams_plain in every form (serving, with the
             adjoint products, and the defer_first form's, whose edge
             stream leaves out K4's two products of W0's sender and receiver
             blocks), f32 and bf16, latents 32-256, 1-3 hidden layers, 1 and
             15 rounds, both MLPs and each alone; K4's defer form on a
             stream row whose last byte is the last mapped byte (CUDA
             virtual memory: the next granule unmapped), the same bits as
             in ordinary memory; and the guard's control in a process of
             its own: K4's three-part form on such a row, reading past it,
             must fault;
4. K4, K5, K6, K1-perm, K8 — the backward kernels (edge and node stage
             reverses, K4 on K7's projections of the round's v, weight
             gradients, the sender-side segment-sum) against
             their plain versions at the cylinder shapes, f32 and bf16; K4/K5
             also on the 20k-node mesh and the flag, f32 and bf16; the ReLU
             outputs K4 and K5 recompute (and their plain versions') against
             an f64 forward; K6 per MLP round (one grouped call) beside the
             index_select + torch.matmul route for the same round; at every
             one of those shapes the defer_first form too: K4 without
             dvs/dvr (its de and MlpSaved the three-part kernel's bits), K1
             and K1-perm on dh0, K8 (first_layer_adjoint: dv += G_s W0_s^T +
             G_r W0_r^T, two calls the same bits) and K6's N-row products
             v^T G (bf16: the mixed form) against their plain versions;
5. gradient — fused_process's gradients (15 rounds, every leaf, v0, e0)
             through the backward kernels against torch.autograd of
             process_rounds_plain on the card, f32 and bf16, in the
             defer_first form (the rule at E >= N) and in the three-part
             form (pinned), each with a second backward pass that must give
             the same bits; f32 also reported on two more seeds at 1 and 15
             rounds, each gradient (both forms, plain path) also against an
             f64 autograd witness;
6. serving — mgn_tpu_torch.simulate, 20 Euler steps on the 1,900-node channel
             mesh with random weights from a seed and Online normalizers
             filled from a synthetic trajectory; the launch counters show the
             path went through K1, K2, K3 and the weight-stream kernel, and
             the result is held against the same simulate on the CPU (plain
             path); then simulate(solver="tsit5_adaptive") over 3 save
             intervals on the card and on the CPU: tries (accepted,
             rejected) per interval, ms per interval, the two within 1e-3;
7. training — mgn_tpu_torch.train_network on a synthetic channel-flow
             TFRecord dataset of the 1,900-node mesh (written by the port's
             writer): 40 steps at full width with two validation sweeps; the
             counters show every kernel ran (the backward in its
             defer_first form: K4's defer form and K8 once a round); a
             train_network call with default Args (validation by the
             adaptive Tsit5 rollout); in one training step the
             backward's K7 on each round's saved v gives the forward's P and
             Q bit for bit; one frame's whole-model gradient and three
             noise-free steps are held against the CPU plain path; ms per
             training step and the device's idle share;
8. K3 extra — K3's node_extra form (an f32 first-layer offset, the cloth
             family's) at the flag's shapes (N_pad 1,664, latent 128, 2
             hidden layers), f32 and bf16, against node_round_plain(extra=);
             a null or zero extra gives the bits of the call without it;
9. cloth serving — mgn_tpu_torch.serve.cloth_simulator on the 50 x 32 flag
             (FlagSimple size: N 1,600, E 9,274 mesh edges, world radius
             0.05, 6,656 world-edge slots), random weights from a seed,
             Online normalizers filled from a 22-frame make_flag_trajectory,
             20 steps at latent 128, 2 hidden layers, 15 rounds, f32 and
             bf16: the counters and the profiler show K2, K3 (extra form),
             K1 (mesh and world sets) and weight_streams ran; each of the
             first 10 steps recomputed on the CPU from the card's state, and
             the rollout's first 10 steps against the same call with
             device="cpu", world-edge
             differences per step reported; ms per step, device busy and
             idle share;
10. K5 extra — K5's node_extra form (the offset in, its cotangent dxtr out)
             at the flag's shapes, f32 and bf16, against
             node_round_bwd_plain(extra=) for dv, dagg, dxtr and the parts
             K6 reads; the control (a zero extra: another forward's ReLU
             masks) must fail that check; a zero extra gives the bits of K5
             without it;
11. cloth training — mgn_tpu_torch.train_network on a TFRecord dataset of
             the 50 x 32 flag (written by the port's writer): 20 steps at
             latent 128, 2 hidden layers, 15 rounds, 6,656 world-edge slots,
             with a validation sweep; the counters show every kernel of the
             path ran (K3 and K5 in their extra forms only); then its step
             on one trajectory: ms per step, device busy and idle share,
             device kernels per step by the profiler, peak memory; one
             frame's whole-model gradient (world-set leaves included) on the
             card against the CPU plain path on the same world edges, two
             backward passes with the same bits, and three noise-free steps
             against the CPU;
11b. union training — mgn_tpu_torch.train_network(batchsize=2) on the
             training phase's dataset: its two training trajectories as one
             disjoint-union graph a step (B·N_pad 3,840, B·E_pad 22,528, two
             trash rows), 20 steps at full width with one validation sweep;
             every kernel of the defer_first backward launched, no
             three-part K4; the union step's ms, wrapper calls and device
             kernels per step, device busy and idle share beside the
             single-graph step's, peak memory; the union's fused_process on
             the subgraphs' encoded latents against one call a subgraph, bit
             for bit (f32, bf16), the whole forward within 1e-3; one union
             frame's whole-model gradient against the CPU plain path;
11c. eval  — eval_network's rollouts (api.eval_rollouts) on the card for
             the training phase's checkpoint and its dataset's test
             trajectory: Euler over 20 steps and the adaptive Tsit5 over 5
             save intervals, each within 1e-3 of the CPU plain path's, the
             same report horizons, steps per second; eval_network whole,
             its export (trajectories.npz without h5py, as on the card) the
             Euler rollout's bits;
             the cloth twin's rollout on the flag checkpoint of phase 11's
             test trajectory. 11b and 11c run after every other phase, so
             those run as they did without them;
11d. solver training — on the training phase's dataset at full width
             (random weights from a seed): one Euler SolverTraining step
             over 5 save intervals with remat on and off, the same bits in
             loss and gradient, each against the CPU plain path (the
             training tolerance); one MultipleShooting step through the
             bounded adaptive Tsit5 (interval_size 3, 2 save intervals,
             budget 4) against the CPU with the same (accepted, rejected)
             tries per interval; train_network(SolverTraining) for 5 steps
             at batchsize 1 and 2; the step's host ms, device busy ms,
             idle share and device kernels by the profiler and its peak
             memory, remat on and off; one bf16 step, finite, its gradient
             against f32's;
11e. cli   — python -m mgn_tpu_torch in processes of their own: synth
             (cylinder, 1,900 nodes, TFRecord), train --strategy shooting
             for 2 steps with a checkpoint, again to 4 (a resume), eval,
             which runs to the end and writes trajectories.npz where h5py
             is missing, synth --family plate and convert inspect on it.
             11d and 11e run after 11c;
11f. export — the serving artefacts (mgn_tpu_torch.serve), after every
             other phase: the cylinder of phase 6 at full width (its first
             10 Euler steps) exported on the card (seconds,
             bytes, the graph's operators, clones and functionalising
             wrappers), run in a fresh python3 that imports load_simulator:
             simulate's bits, 10 weight_streams and 150 each of K7, K2, K1
             and K3 by the
             counters and by the profiler (guarded), load seconds, host ms
             per step beside simulate's, device busy beside simulate's; an
             artefact of the first 5 steps exported on the CPU and moved to
             the card at load (the card artefact's bits), and one in bf16
             (simulate(compute_dtype="bfloat16")'s bits); the flag's f32
             cloth artefact (cloth_simulator's bits over 20 steps), exported
             by a process of its own (--export-flag) started after the build,
             whose host work overlaps the earlier phases;
11g. families — after every other phase (a later profile drops events
             otherwise): the airfoil (make_channel_mesh(5233): 5,233 nodes,
             30,788 edges; velocity and density targets), the deforming
             plate (a 16 x 16 x 5 grid: 1,280 nodes, 6,848 edges; world_pos
             and an absolute stress head) and NS (the NS generator's
             1,900-node cylinder mesh on a 128 x 64 grid, bf16), each written
             as TFRecord, trained by train_network (20, 10 and 5 steps) and
             evaluated by eval_network (Euler; its export read back) at
             latent 128, 2 hidden layers, 15 rounds: every kernel of the
             defer_first path by the counters and K1-K8 and weight_streams
             by the guarded profiler, device busy ms a step and idle share,
             the rollout (the airfoil's 5 steps) against the CPU plain path's (f32 max |du| <= 1e-3;
             bf16 relative L2 <= 5e-2 of the f32 one), one frame's gradient
             by the training tolerance (bf16: check_bf16_accuracy), the edge
             route build_template took (ops/native), the seconds of each
             part; then the four examples' main(argv) (2 steps and an
             eval each), synth --family airfoil and convert stats in this
             process;
11h. parallel — graph parallelism over torch.distributed (mgn_tpu_torch.
             parallel, api_spmd), after every other phase, on
             make_channel_mesh(5233) with the cylinder writer's fields (tl
             22, one trajectory a split) at latent 128, 2 hidden layers, 15
             rounds, f32, each rank a process of its own (parallel.mesh.
             spawn; the kernels built here first): the single-device
             references on the card (train_network 10 noise-free steps,
             simulate 20 Euler steps, eval_rollouts' adaptive Tsit5 over 5
             save intervals, one frame's gradient, one SGD step); mesh
             (1, 1) over NCCL (make_spmd_derivative_step's step and a 5-step
             make_sharded_rollout_fn rollout, the rollout's bits and the
             step's update by the gradient rule); mesh (1, 2) over gloo, two
             ranks sharing the card: which collectives gloo takes on CUDA
             tensors, simulate(graph_parallel=2) deep and classic (max |du|
             <= 1e-3), train_network's 10 losses (rtol 1e-3), eval_network's
             adaptive rollout (the tries the same on both ranks, max |du|
             <= 1e-3), one frame's gradient by the gradient rule, and per
             rank the guarded profiler's kernels of a training step (K1-K8,
             weight_streams), device busy ms of a training and a serving
             step, the exchange's bytes and host ms, seconds by part;
11i. parallel train — A7b's training paths, after phase_parallel, on its
             dataset and checkpoint, held against the single-device path on
             the card: graph-parallel solver training (train_network with
             SolverTraining, Euler over 5 save intervals with remat, 3
             steps, losses rtol 1e-3; one step each of Euler, the bounded
             adaptive Tsit5 and MultipleShooting from the initial state,
             loss rtol 1e-3, gradient by the rule, the Tsit5's tries the
             same on both ranks and the single device, whose reference is
             bucketed to the parts' P * N_p rows, the sharded error norm's
             count; mesh (1, 1) over
             NCCL, one Euler step, the loss's bits and the gradient by the
             rule), the telescoped deep stages (simulate(graph_parallel=2,
             telescope_stages=3) 20 Euler steps, max |du| <= 1e-3 against
             simulate and the untelescoped plan; one frame's gradient by
             the rule; each stage's rows) and the sharded cloth family (a
             12-frame 50 x 32 flag, its world capacity above its most
             within-radius pairs counted on the host: train_network 3
             noise-free steps, rtol 1e-3; each test frame's world edges of
             the parts together the single-device set; one step's
             gradient summed over the parts by the rule; eval_network's 10
             rollout steps, max |dx| <= 1e-3), with per rank the guarded
             profiler's device busy ms and idle share of a step of each
             path (the telescoped and the untelescoped derivative step),
             launches per kernel per path and each collective's bytes and
             host ms;
11j. artefacts — after phase_parallel_train: export_simulator(solver=
             "tsit5_adaptive") of the serving call over 5 save intervals,
             exported on the card and loaded (the eager tries, max |du|
             <= 1e-5, 7 forwards a try by the counters and the profiler,
             the graph's operators in both while_loops, export and load
             seconds, bytes); export_sharded_simulator /
             load_sharded_simulator on phase_parallel's test trajectory,
             two meshes (1, 2) over gloo side by side (deep and classic
             Euler 5 steps, deep adaptive over 3 intervals: the ranks the
             same, simulate(graph_parallel=2) and single-device simulate
             within 1e-3, the bits reported, the tries the eager ones,
             launches, export and load seconds per rank, bytes) and mesh
             (1, 1) over NCCL (deep Euler); the multihost twin's first
             window at full width (finite losses, the same on both ranks);
11k. widths — latent widths the kernels are not built for, after
             phase_artefacts: every kernel (the weight streams, K7, K2, K1
             and K1-perm at the tile and at the real width, K3 and its
             extra form, K5 in both forms, K4 three-part and defer, K8, K6
             per MLP round) at widths 90, 96 and 200 on its padded tile
             (128, 128, 256), f32 and bf16, against its plain version under
             the rule it is held to at the built widths, every padded
             column exactly 0, and its device ms at 96 beside its bound at
             96; the cylinder model (15 rounds, 2 hidden layers) at
             layer_size 96: simulate's 10 Euler steps f32 and bf16, one
             frame's gradient (the backward's padded columns 0) and one
             noise-free derivative step against the plain route on the card
             (the models' fused_process swapped for process_rounds_plain),
             device busy of a serving call and a training step at 96 beside
             128; the flag at 90 (train_network 20 steps, then one frame's
             gradient against the CPU plain path and one cloth step against
             the plain route); python -m mgn_tpu_torch train --layer-size 96;
12. report — per-kernel times, launches, errors and bounds as one JSON line,
             the card's name and power limit, and the final status line.

Run from the repository root:  python3 chip_smoke.py
Exits non-zero without a CUDA device.

``python3 chip_smoke.py --k3-bits FILE`` only builds K3 and runs it without
extra (15 rounds, cylinder and flag shapes, f32 and bf16) on seeded inputs:
it writes the results to FILE, or, where FILE exists, holds them bit for bit
against it.  Copied into a checkout of an earlier commit and run there
first, it shows that K3 without extra keeps that commit's bits.  This mode
needs only names the port has had since its K3 took weight streams, so the
cloth modules are imported inside the phases that use them.
``python3 chip_smoke.py --k5-bits FILE`` does the same for K5 without
extra (one round, cylinder and flag shapes, f32 and bf16, every output).
Its inputs need the node stream with K5's adjoint products, so it holds K5
against a file written from a tree whose K5 reads that stream (the 16-node
tensor-core K5); a file from an earlier K5 (another summation order) is
expected to differ.
``python3 chip_smoke.py --proj-bits FILE`` does the same for K7 and K8
(latent 128 at the cylinder's, the flag's and the 20k-node mesh's row
counts, latents 32, 64 and 256 at the cylinder's, f32 and bf16: P, Q and
dv), and prints both kernels' device time at the cylinder beside one f32
torch.matmul of the same product.  It needs only names the port has had
since K8: run in a checkout of an earlier commit and then in this one, in
one call, it shows that the projection tile keeps the earlier kernels'
bits, and times both on one card.
``python3 chip_smoke.py --k2-bits FILE`` does the same for K2 (latent 128
at the cylinder's, the flag's and the 20k-node mesh's edges, latents 32, 64
and 256 at the cylinder's, 1, 63, 64 and 65 rows; f32 and bf16: msg and the
updated e), and ``--k2-time`` only builds K2 and prints its device time and
the wrapper's host time a call at the cylinder, f32 and bf16, beside its
launch shape and the weight bytes a launch copies from L2. Both need only
names the port has had since K2 took the pre-projected form: copied into a
checkout of an earlier commit and run there and here in one call, they show
that K2 keeps that commit's bits, and time both K2s on one card.
``python3 chip_smoke.py --k1-time`` only builds K1 and times it and K1-perm
at the cylinder's and the flag's templates, f32 and bf16, and the world
set's K1-perm (see k1_time);
copied into a checkout of an earlier commit it times that commit's K1.
``python3 chip_smoke.py --k6-time`` only builds K6 and times it at the
cylinder (see k6_time), split by device kernel, after holding each call
against its plain version.
``python3 chip_smoke.py --host-time`` only builds the forward and training
kernels and prints one JSON line: simulate's host ms per Euler step and the
cylinder's derivative training step's, at full width (see host_time);
copied into a checkout of an earlier commit it times that commit's routes.
``python3 chip_smoke.py --export-flag PATH`` writes the export phase's flag
artefact to PATH (the full run starts it in a process of its own).
``python3 chip_smoke.py --ws-time`` only builds the weight-stream kernel and
times it in every form a tree has (see ws_time) beside each form's bytes,
its bound and a device copy of the same bytes; copied into a checkout of an
earlier commit it times that commit's kernel.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
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
from mgn_tpu_torch.utils.profiling import guarded_profile

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
FORWARD = ("csr_segment_sum", "edge_project", "edge_round", "node_round", "weight_streams")
KERNELS = {"csr_segment_sum": csr_segment_sum, "edge_project": F.edge_project,
           "edge_round": F.edge_round,
           "node_round": F.node_round, "weight_streams": F.weight_streams,
           "edge_round_bwd": F.edge_round_bwd,
           "node_round_bwd": F.node_round_bwd, "wgrad": F.wgrad,
           "first_layer_adjoint": F.first_layer_adjoint}


# the wrappers' second counters: a form of a kernel counted on its own
FORMS = {"csr_segment_sum_perm": (csr_segment_sum, "perm_launches"),
         "node_round_extra": (F.node_round, "extra_launches"),
         "node_round_bwd_extra": (F.node_round_bwd, "extra_launches"),
         "edge_round_bwd_defer": (F.edge_round_bwd, "defer_launches")}
# what a training step's backward launches where E >= N (every mesh here):
# K4's defer_first form and K8, and not K4's three-part form
THREE_PART = ("edge_round_bwd",)


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    for fn, attr in FORMS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    counts = {name: k.launches for name, k in KERNELS.items()}
    counts.update({name: getattr(fn, attr) for name, (fn, attr) in FORMS.items()})
    return counts


T_START = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("phase "):  # where each phase starts, on the run's clock
        msg += f"  [{time.perf_counter() - T_START:.1f} s into the run]"
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


# Every profile here runs its work between guards
# (mgn_tpu_torch.utils.profiling.guarded_profile): a profile can drop the
# device events at either end of its session, the more the older the
# process (probes/profiler_drift, PERF.md §6, PR 19); K3 extra's 50-call
# profile kept 24 six minutes into a run, and two casts opening a bf16
# forward went missing.  A profile whose guards were not both recorded is
# taken again, and three such raise.


def _device_profile(fn, iters: int, warmup: int, match: str,
                    kernels: int | None) -> tuple:
    """``(spans, per_call, n_kernels)``: each device activity's recorded
    durations (us) by name over ``iters`` calls, its whole number of runs a
    call, and the kernels a call runs.  A profile that loses events is taken
    again, up to three in all, and the last usable one used with a note;
    raises where no profile is usable: its guards not both recorded, no
    device activity, an activity in fewer than half the calls, or another
    kernel count than ``kernels``."""
    for _ in range(warmup):
        fn()
    used, seen = None, []
    for _ in range(3):
        with guarded_profile() as g:
            for _ in range(iters):
                fn()
        spans = {}
        for ev in g.events:
            if match in ev.name:
                spans.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
        per_call = {name: round(len(d) / iters) for name, d in spans.items()}
        n_kernels = sum(c for name, c in per_call.items() if not is_copy(name))
        lost = sum(c * iters - len(spans[name]) for name, c in per_call.items())
        seen.append({"intact": g.intact, **{name: len(d) for name, d in spans.items()}})
        if g.intact and spans and all(per_call.values()) and kernels in (None, n_kernels):
            used = (spans, per_call, n_kernels, lost)
            if lost == 0:
                break
    if used is None:
        raise RuntimeError(f"torch.profiler's device events matching {match!r} over {iters} "
                           f"calls, three profiles: {seen}; expected "
                           f"{'some' if kernels is None else kernels} kernels a call")
    spans, per_call, n_kernels, lost = used
    if lost:
        log(f"  note: the profiler's device events matching {match!r} were {lost} short of "
            f"{iters} whole calls in every usable profile of 3; timed by each activity's "
            "mean duration")
    return spans, per_call, n_kernels


def device_time(fn, iters: int = 50, warmup: int = 5, match: str = "",
                kernels: int | None = None) -> tuple:
    """(device ms per call, device kernels per call) from the GPU activity
    (kernels, copies) that torch.profiler records over ``iters`` calls; with
    ``match``, only activity whose name contains it (one wrapper's kernels,
    without the copies that reset its inputs).  Host-side launch cost is
    left out.  The profiler loses a device event now and then, which would
    make a sum over ``iters`` read fast: so each activity counts as its mean
    recorded duration times the whole number of times a call runs it (its
    count over ``iters``, rounded).  ``kernels``, where given, is the number
    of kernels one call launches (see _device_profile)."""
    spans, per_call, n_kernels = _device_profile(fn, iters, warmup, match, kernels)
    ms = sum(sum(d) / len(d) * per_call[name] for name, d in spans.items()) / 1e3
    return ms, n_kernels


def device_split(fn, iters: int = 200, match: str = "") -> dict:
    """Device ms per call of each kernel whose name contains ``match``, by
    its short name (``wgrad_partial_kernel`` ...), timed as device_time
    times the whole call."""
    spans, per_call, _ = _device_profile(fn, iters, 5, match, None)
    out = {}
    for name, d in spans.items():
        m = re.search(r"(\w+_kernel)", name)
        key = m.group(1) if m else name
        out[key] = out.get(key, 0.0) + sum(d) / len(d) * per_call[name] / 1e3
    return out


def device_ms(fn, iters: int = 50, warmup: int = 5, match: str = "",
              kernels: int | None = None) -> float:
    return device_time(fn, iters, warmup, match, kernels)[0]


def timings(fn, iters: int = 50, kernels: int | None = None) -> tuple:
    """(device ms per call, host-bound ms per call)."""
    return device_ms(fn, iters, kernels=kernels), time_ms(fn, iters)


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


def hold_k1(label, data, ids, offsets, n, perm=None) -> int:
    """K1 (K1-perm with ``perm``) on the card against csr_segment_sum_plain
    on the CPU copy of the same inputs, bit for bit (both sum in K1's fixed
    chunk order), and a second call that must give the same bits; returns
    the number of entries held."""
    out = csr_segment_sum(data, ids, offsets, n, perm=perm)
    again = csr_segment_sum(data, ids, offsets, n, perm=perm)
    ref = csr_segment_sum_plain(data.cpu(), ids.cpu(), offsets.cpu(), n,
                                perm=None if perm is None else perm.cpu())
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"K1 {label}: two calls gave other bits")
    got = out.cpu()
    if not torch.equal(got, ref):
        bad = (got != ref) & ~(got.isnan() & ref.isnan())
        rows = torch.nonzero(bad.any(1)).flatten()[:8].tolist()
        worst = float((got - ref).abs().nan_to_num(float("inf")).max())
        raise AssertionError(f"K1 {label}: {int(bad.sum())} entries differ from the CPU plain "
                             f"version, in rows {rows}, max |d| {worst:.3e}")
    return got.numel()


def world_order(t_flag, gen):
    """A stand-in for the cloth model's world set: receivers drawn at random
    over the flag's FLAG["per_node"] x N_pad world-edge slots, 60 % of them
    valid, put in receiver order by csr_order as the model's are (dead slots
    after every row, so no row is long).  Returns ``(ids, valid, perm,
    offsets)``."""
    from mgn_tpu_torch.ops.segment import csr_order

    n, slots = t_flag.num_nodes, FLAG["per_node"] * t_flag.num_nodes
    ids = torch.randint(0, n, (slots,), generator=gen, device="cuda", dtype=torch.int32)
    valid = torch.rand((slots,), generator=gen, device="cuda") < 0.6
    return (ids, valid, *csr_order(ids, n, valid))


def k1_bits(t, t20k, gen) -> int:
    """hold_k1 on every input K1 meets, f32 and bf16, both forms: the
    cylinder's, the flag's and the 20k-node mesh's templates; a synthetic
    CSR with rows of 0, 1, C - 1, C, C + 1, 2C + 1 and 5,000 entries (C =
    CHUNK) at widths 32, 128 and 256; csr_order's output over the flag's
    6,656 world-edge slots with a valid mask, the rows it leaves out NaN
    (they must never be read)."""
    from mgn_tpu_torch.data.synthetic import make_flag_mesh
    from mgn_tpu_torch.ops.csr_segment import CHUNK

    pos, cells, nt = make_flag_mesh(FLAG["nx"], FLAG["ny"])
    t_flag = build_template(pos, nt, cells=cells).to("cuda")
    lengths = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1, 5000]
    offsets = torch.tensor([0, *np.cumsum(lengths)], dtype=torch.int32, device="cuda")
    n_syn, e_syn = len(lengths), sum(lengths)
    ids = torch.repeat_interleave(torch.arange(n_syn, dtype=torch.int32, device="cuda"),
                                  torch.diff(offsets))
    perm = torch.randperm(e_syn, generator=gen, device="cuda").to(torch.int32)
    n_w = t_flag.num_nodes
    ids_w, valid, perm_w, offsets_w = world_order(t_flag, gen)
    slots = ids_w.numel()
    held = 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, tm in (("cylinder", t), ("flag", t_flag), ("20k-node mesh", t20k)):
            data = torch.randn((tm.num_edges, LATENT), generator=gen, device="cuda").to(dtype)
            held += hold_k1(f"{name} {dtype}", data, tm.receivers, tm.row_offsets, tm.num_nodes)
            held += hold_k1(f"perm {name} {dtype}", data, tm.senders, tm.sender_offsets,
                            tm.num_nodes, tm.sender_perm)
        for f in (32, 128, 256):
            scale = 10.0 ** torch.randint(-3, 4, (e_syn, 1), generator=gen, device="cuda")
            data = (torch.randn((e_syn, f), generator=gen, device="cuda") * scale).to(dtype)
            held += hold_k1(f"rows {lengths} F {f} {dtype}", data, ids, offsets, n_syn)
            held += hold_k1(f"perm rows {lengths} F {f} {dtype}", data, ids, offsets, n_syn,
                            perm)
        data = torch.randn((slots, LATENT), generator=gen, device="cuda").to(dtype)
        poisoned = torch.where(valid[:, None], data, torch.full_like(data, float("nan")))
        held += hold_k1(f"csr_order with valid {dtype}", poisoned, ids_w, offsets_w, n_w, perm_w)
    log(f"  K1 and K1-perm bit for bit against the CPU plain version (C = {CHUNK}), two calls "
        f"the same bits: {held} entries (templates: cylinder, flag, 20k-node mesh; rows of "
        f"{lengths} entries at F 32, 128, 256; csr_order of {slots} slots, "
        f"{int(valid.sum())} valid, the rest NaN), f32 and bf16")
    return held


def phase_k1(t, t20k):
    log("phase K1")
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    k1_bits(t, t20k, gen)
    for dtype in (torch.float32, torch.bfloat16):
        err, data = check_k1(t, dtype, gen, f"cylinder {dtype}")
        e_pad, n_pad = t.num_edges, t.num_nodes
        ms, call_ms = timings(lambda: csr_segment_sum(data, t.receivers, t.row_offsets,
                                                      n_pad), 200, kernels=1)
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


# --- phase 2b: K9 and K10, the probes' kernels -----------------------------------

# P7's and P8's shapes (the probes' defaults): K9 gathers 11 chunks of 1,024
# rows (the cylinder's E_pad) from 384-row windows of 2,048 rows, 15 rounds;
# K10 runs 200 rounds of a 512-row gather and a 1,024-row scatter
P7 = dict(chunk=1024, band=384, chunks=11, rounds=15, n=2048)
P8 = dict(band=512, chunk=1024, rounds=200)
PEAK_S8 = 1979e12  # int8 tensor-core operations/s
# K10 against its plain version: every gather is exact and int8 sums are
# integers (bitwise); bf16 and f32 sums of the scatter run in another order
# (the plain version's index_add_ with atomics), max |d| <= 1e-6 max |ref|
K10_TOL = 1e-6


def k9_entry(O, name, variant, dtype, win, v, rounds) -> dict:
    """K9 in one variant against its plain version (bitwise, two calls the
    same bits), device and plain ms, and its bounds."""
    out = O.window_gather(v, win, rounds, variant)
    again = O.window_gather(v, win, rounds, variant)
    ref = O.window_gather_plain(v, win, rounds)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    same, stable = torch.equal(out, ref), torch.equal(again, out)
    log(f"  K9 {name}: the plain version's bits {same}, max_abs_err {err:.3e}; a second call "
        f"the same bits {stable}")
    if not (same and stable and torch.isfinite(out).all()):
        raise AssertionError(f"K9 {name}: bitwise {same}, stable {stable}, max_abs_err {err:.3e}")
    ms = device_ms(lambda: O.window_gather(v, win, rounds, variant), 20, kernels=1)
    plain_ms = device_ms(lambda: O.window_gather_plain(v, win, rounds), 3)
    n_chunks, chunk = win.rel.shape
    n_rows, L = v.shape
    nbytes = n_rows * L * v.element_size() + win.rel.numel() * 4 + n_chunks * 4 + chunk * L * 4
    b_ms, b_by = bound_ms(nbytes, chunk * L * n_chunks * rounds, torch.float32)
    r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             mbytes=nbytes / 1e6)
    if variant == "onehot":
        tc_ops = 2 * chunk * win.band * L * n_chunks * rounds
        r["bound_tc_ms"], r["bound_tc_by"] = bound_ms(nbytes, tc_ops, dtype, PEAK_TC_OPS)
        r["tc_gflop"] = tc_ops / 1e9
    else:
        r["l2_mb"] = n_chunks * rounds * chunk * L * v.element_size() / 1e6
    log(f"  K9 {name}: device {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms "
        f"({b_by}, {nbytes / 1e6:.3f} MB)" + (
            f"; tensor cores {r['bound_tc_ms']:.5f} ms ({r['tc_gflop']:.2f} GFLOP)"
            if variant == "onehot" else f"; L2 rows {r['l2_mb']:.1f} MB"))
    return r


def k10_entry(O, value, pair, rounds) -> dict:
    """K10 on one value route against its plain version, device and plain ms,
    the function's bound (bytes against its f32 adds) and the one-hot
    products' bound at the route's tensor-core rate."""
    out = O.onehot_pair(pair, rounds, value)
    ref = O.onehot_pair_plain(pair, rounds, value)
    torch.cuda.synchronize()
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    ok = (torch.equal(out, ref) if value == "int8" else err <= K10_TOL * scale)
    log(f"  K10 {value}: max_abs_err {err:.3e} (tolerance "
        f"{'bitwise' if value == 'int8' else f'{K10_TOL} x {scale:.3f}'})")
    if not ok or not torch.isfinite(out).all():
        raise AssertionError(f"K10 {value}: max_abs_err {err:.3e}")
    ms = device_ms(lambda: O.onehot_pair(pair, rounds, value), 10, kernels=1)
    plain_ms = device_ms(lambda: O.onehot_pair_plain(pair, rounds, value), 2)
    n_band, L = pair.band.shape
    chunk = pair.rel.shape[0]
    # the function: a band-row gather, a chunk-row scatter and the round's sum
    # into out, in f32 adds; K10's one-hot products on the tensor cores
    adds = (2 * n_band + chunk) * L * rounds
    tc_ops = 2 * L * n_band * (n_band + chunk) * rounds
    nbytes = 4 * (chunk + n_band * L + chunk * L + n_band * L)
    b_ms, b_by = bound_ms(nbytes, adds, torch.float32)
    peak = {"bf16": PEAK_TC_OPS[torch.bfloat16], "f32": PEAK_TC_OPS[torch.float32],
            "int8": PEAK_S8}[value]
    t_tc, t_bytes = tc_ops / peak, nbytes / PEAK_BYTES
    r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             bound_tc_ms=max(t_tc, t_bytes) * 1e3,
             bound_tc_by="operations" if t_tc > t_bytes else "bytes", mbytes=nbytes / 1e6,
             tc_gflop=tc_ops / 1e9)
    log(f"  K10 {value}: device {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms "
        f"({b_by}, {nbytes / 1e6:.3f} MB, {adds / 1e6:.1f} M f32 adds); tensor cores "
        f"{r['bound_tc_ms']:.5f} ms ({r['tc_gflop']:.2f} GFLOP)")
    return r


def k2_gathers(O, t) -> dict:
    """K9's direct variant on the cylinder's edge index: the senders, then the
    receivers, in CSR order, from one window of the N_pad node rows, one
    round: the row traffic of K2's P[s] and Q[r] gathers.  v has E_pad rows
    (the window's first N_pad hold the values; the rest are never read) so
    that the window check's max(band, chunk) holds."""
    rel = torch.stack([t.senders, t.receivers]).cpu().numpy()
    win = O.make_window(rel, np.zeros(2, np.int32), t.num_nodes, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.zeros((win.rows, LATENT), device="cuda", dtype=dtype)
        v[:t.num_nodes] = torch.randn((t.num_nodes, LATENT), generator=gen, device="cuda")
        out = O.window_gather(v, win, 1, "direct")
        ref = O.window_gather_plain(v, win, 1)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"K9 direct on the cylinder's edges {dtype}: not the plain bits")
        ms = device_ms(lambda: O.window_gather(v, win, 1, "direct"), 50, kernels=1)
        res[dtype] = dict(ms=ms, l2_mb=2 * t.num_edges * LATENT * v.element_size() / 1e6)
        log(f"  K9 direct on the cylinder's edge index (senders, receivers; E_pad "
            f"{t.num_edges}, window N_pad {t.num_nodes}) {dtype}: device {ms:.5f} ms, "
            f"{res[dtype]['l2_mb']:.2f} MB of rows")
    return res


def phase_probes(t) -> dict:
    """K9 (window_gather) in P7's four variants, bitwise against its plain
    version, with embedding_bag as the library route; K10 (onehot_pair) on
    its three routes (P8's eight variants) against its plain version; then
    both probes' run() on the card with the launch counters set to 0 just
    before and read just after; and K9's direct variant on the cylinder's
    edge index (K2's gathers)."""
    from mgn_tpu_torch.ops import onehot as O
    from mgn_tpu_torch.probes import dyngather, onehot_dtype

    log("phase probes (K9 window_gather, K10 onehot_pair)")
    rel, starts, v = dyngather.inputs(P7["chunk"], P7["band"], P7["chunks"], P7["n"], LATENT, 0)
    win = O.make_window(rel, starts, P7["band"], "cuda")
    v32 = torch.from_numpy(v).cuda()
    k9 = {name: k9_entry(O, name, variant, dtype, win, v32.to(dtype), P7["rounds"])
          for name, (variant, dtype) in dyngather.COMBOS.items()}
    # the library route: one embedding_bag whose bag i holds row i's R x C indices
    idx = (win.starts[:, None].long() + win.rel.long()).t().repeat(1, P7["rounds"])
    lib = torch.nn.functional.embedding_bag(idx, v32, mode="sum")
    ref = O.window_gather_plain(v32, win, P7["rounds"])
    if not torch.allclose(lib, ref, rtol=1e-5, atol=1e-4):
        raise AssertionError("embedding_bag does not compute K9's function")
    k9["onehot_f32"]["library_ms"] = device_ms(
        lambda: torch.nn.functional.embedding_bag(idx, v32, mode="sum"), 20)
    log(f"  library embedding_bag f32: device {k9['onehot_f32']['library_ms']:.5f} ms")

    pair = O.make_pair_inputs(*onehot_dtype.inputs(P8["band"], P8["chunk"], LATENT, 0), "cuda")
    # P8's eight variants are K10's three routes, each checked once
    k10 = {value: k10_entry(O, value, pair, P8["rounds"]) for value in O.PAIR_VALUES}
    log("  K10: the eight variants of P8 by route: " + json.dumps(
        {value: [n for n, (_, v) in onehot_dtype.VARIANTS.items() if v == value]
         for value in O.PAIR_VALUES}))

    O.window_gather.launches = O.onehot_pair.launches = 0
    rec7 = dyngather.run(**P7)
    rec8 = onehot_dtype.run(**P8)
    launches = {"window_gather": O.window_gather.launches,
                "onehot_pair": O.onehot_pair.launches}
    out7, out8 = rec7.pop("outputs"), rec8.pop("outputs")
    for name, out in {**out7, **out8}.items():
        if not torch.isfinite(out).all():
            raise AssertionError(f"probe output {name} is not finite")
    if rec7["rel_err_vs_onehot_f32"]["dyn_f32"] != 0.0 or not torch.equal(
            out7["onehot_bf16"], out7["dyn_bf16"]):
        raise AssertionError("P7: the variants do not gather the same values")
    if not all(launches.values()):
        raise AssertionError(f"the probes did not launch every kernel: {launches}")
    log(f"  probe launches: {json.dumps(launches)}")
    log("  dyngather: " + json.dumps(rec7))
    log("  onehot_dtype: " + json.dumps(rec8))
    return dict(k9=k9, k10=k10, launches=launches, dyngather=rec7, onehot_dtype=rec8,
                k2_gathers=k2_gathers(O, t))


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


def profiled(fn) -> tuple:
    """``(device events, wall ms)`` of one ``fn()`` under torch.profiler
    (:func:`guarded_profile`): kernels, copies and fills, without the spans
    that annotations such as ``Optimizer.step#Adam.step`` leave on the
    device timeline (they overlap the kernels they enclose, which a sum of
    device time would count twice).  A profile whose guards were not both
    recorded, or that recorded no device activity of ``fn``, is taken
    again; raises after three such."""
    for _ in range(3):
        with guarded_profile() as g:
            fn()
        if g.events and g.intact:
            return g.events, g.wall_ms
        log(f"  note: a profile kept {len(g.events)} device events of its work and "
            f"{'both' if g.intact else 'not both'} guards; profiled again")
    raise RuntimeError("torch.profiler lost device events in three profiles of one call: "
                       "its guards not both recorded, or no device activity")


def kernel_counts(fn) -> dict:
    """Device kernels (copies and fills left out) that torch.profiler saw
    during one ``fn()``, by name."""
    counts = {}
    for ev in profiled(fn)[0]:
        if not is_copy(ev.name):
            counts[ev.name] = counts.get(ev.name, 0) + 1
    return counts


# the device kernels of one forward, by the name they carry in a profile
FORWARD_KERNELS = {"edge_project": "edge_project_kernel", "edge_round": "edge_round_kernel",
                   "csr_segment_sum": "csr_segment_sum_kernel",
                   "node_round": "node_round_kernel",
                   "weight_streams": "weight_streams_kernel"}


def check_forward_launches(fwd, dtype) -> dict:
    """One fused_process call's device kernels: K7, K2, K1 and K3 once per
    round and one weight-stream launch (1 + 4 MPS).  In f32 nothing else
    runs; in bf16 the f32 master weights and biases are also cast to bf16
    (one kernel each), as every forward has done since the first slice.  The
    profiler drops a device event now and then, so a call whose profile
    shows other counts is profiled again, up to three times in all."""
    want = {"edge_project": MPS, "edge_round": MPS, "csr_segment_sum": MPS, "node_round": MPS,
            "weight_streams": 1}
    casts = 2 * 2 * (HIDDEN + 1) if dtype == torch.bfloat16 else 0
    for attempt in range(3):
        seen = kernel_counts(fwd)
        got = {k: sum(n for name, n in seen.items() if pat in name)
               for k, pat in FORWARD_KERNELS.items()}
        other = sum(seen.values()) - sum(got.values())
        if got == want and other == casts:
            break
        log(f"  note: profile {attempt + 1} of one fused_process call {dtype} counted {got}, "
            f"other {other}")
    log(f"  device kernels of one fused_process call {dtype} (profiler): {got}, "
        f"other {other} (expected {want}, other {casts})")
    if got != want or other != casts:
        raise AssertionError(f"fused_process {dtype} launched {seen}")
    return dict(got, other=other)


# K7 against its plain version: both sum L exact (bf16) or 3xTF32 (f32)
# products in f32 in other orders, so an entry differs by a few f32 ulps of
# the sum of |v w|: max |dP| <= 1e-4 x max(1, max |P|) in both dtypes
K7_TOL = 1e-4


def phase_k7(shapes, proc) -> dict:
    """K7 at each ``(label, N_pad)`` of ``shapes`` against its plain version,
    f32 and bf16; two calls give the same bits.  Device time, bound, plain
    time and the library route (one f32 torch.matmul of v by the sender and
    receiver blocks side by side) at the first shape, the cylinder's."""
    log("phase K7")
    gen = torch.Generator(device="cuda").manual_seed(14)
    L = LATENT
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        em = F.cast_mlp(proc["edge_mlp"], dtype)
        em0, ws_p = F.round_params(em, 0), F.weight_streams(em)[2][0]
        errs = {}
        for label, n_pad in shapes:
            v = torch.randn((n_pad, L), generator=gen, device="cuda").to(dtype)
            p, q = F.edge_project(v, em0, ws_p)
            ref = F.edge_project_plain(v, em0)
            again = F.edge_project(v, em0, ws_p)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip((p, q), ref))
            scale = max(1.0, max(float(b.abs().max()) for b in ref))
            same = torch.equal(again[0], p) and torch.equal(again[1], q)
            log(f"  K7 {label} (N_pad {n_pad}) {dtype}: max_abs_err {err:.3e} (tolerance "
                f"{K7_TOL} x {scale:.3f}); a second call the same bits: {same}")
            if not err <= K7_TOL * scale or not same:
                raise AssertionError(f"K7 {label} {dtype}: max_abs_err {err:.3e}, same bits {same}")
            errs[label] = err
            if label == shapes[0][0]:
                v0 = v
        n_pad = shapes[0][1]
        ms, kpc = device_time(lambda: F.edge_project(v0, em0, ws_p), kernels=1)
        plain_ms = device_ms(lambda: F.edge_project_plain(v0, em0))
        lib_ms = None
        if dtype == torch.float32:
            w_cat = torch.cat([em0["w"][0][L:2 * L], em0["w"][0][2 * L:]], dim=1).contiguous()
            lib = torch.matmul(v0, w_cat)
            ref = F.edge_project_plain(v0, em0)
            if not torch.allclose(lib, torch.cat(ref, dim=1), rtol=1e-5, atol=1e-4):
                raise AssertionError("torch.matmul does not compute K7's function")
            lib_ms = device_ms(lambda: torch.matmul(v0, w_cat))
        b = torch.finfo(dtype).bits // 8
        ops = 2 * 2 * n_pad * L * L
        nbytes = n_pad * L * b + 2 * L * L * b + 2 * n_pad * L * 4
        b_ms, b_by = bound_ms(nbytes, ops, dtype)
        tc_ms, tc_by = bound_ms(nbytes, ops, dtype, PEAK_TC_OPS)
        res[dtype] = dict(max_abs_err=max(errs.values()), max_abs_err_by_shape=errs, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                          bound_tc_ms=tc_ms, bound_tc_by=tc_by, gflop=ops / 1e9,
                          mbytes=nbytes / 1e6, device_launches_per_call=kpc)
        log(f"  K7 {dtype} (N_pad {n_pad}): device {ms:.5f} ms, plain {plain_ms:.5f} ms, "
            f"library {lib_ms}, bound {b_ms:.5f} ms ({b_by}, {ops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB; tensor cores {tc_ms:.5f} ms, {tc_by})")
    return res


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
        # K2's, K3's and K7's weight streams for every round, against their plain version
        ws = F.weight_streams(em, nm)
        ref_ws = F.weight_streams_plain(em, nm)
        torch.cuda.synchronize()
        if not all(torch.equal(as_bits(a), as_bits(b)) for a, b in zip(ws, ref_ws)):
            raise AssertionError(f"weight_streams {dtype}: differ from their plain version")
        ws_e, ws_n, _ = ws
        ws_mb = sum(x.numel() for x in ws) * ws_e.element_size() / 1e6
        log(f"  weight streams {dtype}: {MPS} rounds, {ws_mb:.3f} MB, the same bits as their "
            "plain version")
        # K2 and K3, one round, on the round's part of the streams as
        # fused_process gives it; K2 on the plain projections of v0
        p, q = F.edge_project_plain(v0, em0)
        e_k = e0.clone()
        msg_k = F.edge_round(e_k, p, q, t.senders, t.receivers, ev, em0, ws_e[0])
        e_p, msg_p = F.edge_round_plain(e0, p, q, t.senders, t.receivers, ev, em0)
        torch.cuda.synchronize()
        k2_err = err_stats(msg_k, msg_p)
        check_tol("K2 one round (msg)", dtype, *k2_err)
        check_tol("K2 one round (e)", dtype, *err_stats(e_k, e_p))
        if msg_k[~t.edge_mask].any():
            raise AssertionError("K2: a dead edge produced a message")
        # the control: K2 with Q zeroed (the receivers' projections unread)
        # must fail K2's check
        ctrl = F.edge_round(e0.clone(), p, torch.zeros_like(q), t.senders, t.receivers, ev,
                            em0, ws_e[0])
        try:
            check_tol("K2 zero-Q control (msg)", dtype, *err_stats(ctrl, msg_p))
        except AssertionError:
            ctrl_err = err_stats(ctrl, msg_p)
        else:
            raise AssertionError(f"K2 {dtype}: the check passes K2 with Q zeroed")
        log(f"  K2 zero-Q control {dtype}: refused (max_abs_err {ctrl_err[0]:.3e}, rel_l2 "
            f"{ctrl_err[1]:.3e})")
        # K3, one round, on the plain aggregate of the same messages
        agg = csr_segment_sum_plain(msg_p, t.receivers, t.row_offsets, n_pad)
        v_k = v0.clone()
        F.node_round(v_k, agg, nm0, ws_n[0])
        v_p = F.node_round_plain(v0, agg, nm0)
        torch.cuda.synchronize()
        k3_err = err_stats(v_k, v_p)
        check_tol("K3 one round (v)", dtype, *k3_err)
        # the whole processor
        fwd = lambda: F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev,
                                      MPS)
        out = fwd()
        for form, pre in (("pre-projected", True), ("three-part", False)):
            ref = F.process_rounds_plain(proc, v0, e0, t.senders, t.receivers, ev, MPS, dtype,
                                         n_pad, preproject=pre)
            torch.cuda.synchronize()
            check_tol(f"fused_process {MPS} rounds (v) against the {form} plain rounds", dtype,
                      *err_stats(out, ref))
        launches = check_forward_launches(fwd, dtype)

        plan = k2_plan(e_pad, LATENT, dtype)
        e_t = e0.clone()
        k2_ms, k2_call = timings(lambda: F.edge_round(e_t, p, q, t.senders, t.receivers, ev,
                                                      em0, ws_e[0]), kernels=1)
        k2_plain, _ = timings(lambda: F.edge_round_plain(e0, p, q, t.senders, t.receivers, ev,
                                                         em0))
        v_t = v0.clone()
        k3_ms, k3_call = timings(lambda: F.node_round(v_t, agg, nm0, ws_n[0]), kernels=1)
        k3_plain, _ = timings(lambda: F.node_round_plain(v0, agg, nm0))
        ws_ms, ws_call = timings(lambda: F.weight_streams(em, nm), kernels=1)
        ws_plain_ms, _ = timings(lambda: F.weight_streams_plain(em, nm))
        fwd_ms, fwd_call = timings(fwd, 10)
        fwd_plain, fwd_plain_call = timings(lambda: F.process_rounds_plain(
            proc, v0, e0, t.senders, t.receivers, ev, MPS, dtype, n_pad), 10)
        b = torch.finfo(dtype).bits // 8
        # K2 reads W0's e rows and the hidden layers, and the f32 P and Q
        w_e = (1 + HIDDEN) * LATENT * LATENT * b + (HIDDEN + 1) * LATENT * b + 2 * LATENT * 4
        w_n = (2 + HIDDEN) * LATENT * LATENT * b + (HIDDEN + 1) * LATENT * b + 2 * LATENT * 4
        k2_ops = 2 * e_pad * (1 + HIDDEN) * LATENT * LATENT
        k2_bytes = ((3 * e_pad * LATENT + e_pad) * b + 2 * n_pad * LATENT * 4 + 2 * e_pad * 4
                    + w_e)
        k3_ops = 2 * n_pad * (2 + HIDDEN) * LATENT * LATENT
        k3_bytes = 2 * n_pad * LATENT * b + n_pad * LATENT * 4 + w_n
        # the weight streams read every round's forward weights once and write
        # the streams once; they convert and move, no arithmetic
        ws_bytes = (MPS * (5 + 2 * HIDDEN) * LATENT * LATENT * b
                    + sum(x.numel() for x in ws) * ws_e.element_size())
        k2_b, k2_by = bound_ms(k2_bytes, k2_ops, dtype)
        k3_b, k3_by = bound_ms(k3_bytes, k3_ops, dtype)
        ws_b, ws_by = bound_ms(ws_bytes, 0, dtype)
        # the same bounds at the tensor-core rate K2 and K3 run at
        k2_tc, k2_tc_by = bound_ms(k2_bytes, k2_ops, dtype, PEAK_TC_OPS)
        k3_tc, k3_tc_by = bound_ms(k3_bytes, k3_ops, dtype, PEAK_TC_OPS)
        res[dtype] = {
            "edge_round": dict(max_abs_err=k2_err[0], ms=k2_ms, plain_ms=k2_plain,
                               bound_ms=k2_b, bound_by=k2_by, bound_tc_ms=k2_tc,
                               bound_tc_by=k2_tc_by, call_ms=k2_call),
            "node_round": dict(max_abs_err=k3_err[0], ms=k3_ms, plain_ms=k3_plain,
                               bound_ms=k3_b, bound_by=k3_by, bound_tc_ms=k3_tc,
                               bound_tc_by=k3_tc_by, call_ms=k3_call),
            "weight_streams": dict(max_abs_err=0.0, ms=ws_ms, plain_ms=ws_plain_ms,
                                   bound_ms=ws_b, bound_by=ws_by, call_ms=ws_call),
            "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain,
            "forward_call_ms": fwd_call, "forward_plain_call_ms": fwd_plain_call,
            "forward_device_kernels": launches}
        log(f"  K2 {dtype}: device {k2_ms:.5f} ms, plain {k2_plain:.5f} ms, bound {k2_b:.5f} ms "
            f"({k2_by}, {k2_ops / 1e9:.3f} GFLOP; tensor cores {k2_tc:.5f} ms, {k2_tc_by}); "
            f"per call back to back {k2_call:.5f} ms; one device kernel a call of "
            f"{plan['grid']} blocks, {plan['stages']} ring stages (the kernel's own plan), "
            f"{plan['l2_weight_bytes'] / 1e6:.3f} MB of weights from L2 (edge_plan's count)")
        log(f"  K3 {dtype}: device {k3_ms:.5f} ms, plain {k3_plain:.5f} ms, bound {k3_b:.5f} ms "
            f"({k3_by}, {k3_ops / 1e9:.3f} GFLOP; tensor cores {k3_tc:.5f} ms, {k3_tc_by}); "
            f"per call back to back {k3_call:.5f} ms")
        log(f"  weight streams {dtype} ({MPS} rounds): device {ws_ms:.5f} ms, plain "
            f"{ws_plain_ms:.5f} ms, bound {ws_b:.5f} ms ({ws_by}); per call back to back "
            f"{ws_call:.5f} ms")
        log(f"  processor {MPS} rounds {dtype}: device {fwd_ms:.4f} ms (plain {fwd_plain:.4f}); "
            f"per call back to back {fwd_call:.4f} ms (plain {fwd_plain_call:.4f})")
    # P4: the same kernels on a mesh ten times larger, one round
    v0, e0, ev = processor_inputs(t20k, torch.float32, gen)
    out = F.fused_process(proc, v0, e0, t20k.senders, t20k.receivers, t20k.row_offsets, ev, 1)
    ref = F.process_rounds_plain(proc, v0, e0, t20k.senders, t20k.receivers, ev, 1,
                                 torch.float32, t20k.num_nodes, preproject=True)
    torch.cuda.synchronize()
    check_tol("fused_process 20k-node mesh, 1 round (v)", torch.float32, *err_stats(out, ref))
    return res


# --- the weight streams ---------------------------------------------------------------

# the streams' forms, (adjoint, defer) as weight_streams takes them
WS_FORMS = {"serving": (False, False), "adjoint": (True, False), "defer": (True, True)}


def stream_mlps(L: int, hidden: int, rounds: int, dtype, seed: int = 0):
    """The cast edge and node MLPs of ``rounds`` rounds at latent ``L``
    (init_mgn, random weights from ``seed``)."""
    cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=L,
                    hidden_layers=hidden, message_passing_steps=rounds)
    proc = init_mgn(cfg, torch.Generator().manual_seed(seed), device="cuda")["processor"]
    return F.cast_mlp(proc["edge_mlp"], dtype), F.cast_mlp(proc["node_mlp"], dtype)


def as_bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


def device_tensor(ptr: int, numel: int, dtype):
    """A tensor over ``numel`` values at device address ``ptr``, memory the
    caller owns (torch's __cuda_array_interface__ import: no copy)."""
    class View:
        __cuda_array_interface__ = {"shape": (numel,), "data": (ptr, False), "version": 3,
                                    "typestr": "<f4" if dtype == torch.float32 else "<i2"}
    t = torch.as_tensor(View(), device="cuda")
    if t.data_ptr() != ptr:
        raise RuntimeError("device_tensor: torch copied the memory instead of viewing it")
    return t if dtype == torch.float32 else t.view(dtype)


class Guarded:
    """``numel`` values of ``dtype`` on the card whose last byte is the last
    mapped byte: CUDA's virtual-memory calls (libcuda) map whole granules
    and leave the granule after them reserved but unmapped, so a kernel
    that reads past the end faults (an illegal address) instead of reading
    a neighbour.  ``with Guarded(n, dtype) as t:``; unmapped at exit."""

    def __init__(self, numel: int, dtype):
        import ctypes

        self.c, self.lib = ctypes, ctypes.CDLL("libcuda.so.1")
        size_t, u64, p = ctypes.c_size_t, ctypes.c_uint64, ctypes.c_void_p

        class Loc(ctypes.Structure):
            _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]

        class Prop(ctypes.Structure):  # CUmemAllocationProp
            _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                        ("location", Loc), ("win32", p), ("flags", ctypes.c_ubyte * 8)]

        class Access(ctypes.Structure):  # CUmemAccessDesc
            _fields_ = [("location", Loc), ("flags", ctypes.c_int)]

        for fn, args in (("cuMemGetAllocationGranularity", [p, p, ctypes.c_int]),
                         ("cuMemAddressReserve", [p, size_t, size_t, u64, u64]),
                         ("cuMemCreate", [p, size_t, p, u64]),
                         ("cuMemMap", [u64, size_t, size_t, u64, u64]),
                         ("cuMemSetAccess", [u64, size_t, p, size_t]),
                         ("cuMemUnmap", [u64, size_t]), ("cuMemRelease", [u64]),
                         ("cuMemAddressFree", [u64, size_t])):
            getattr(self.lib, fn).argtypes = args
            getattr(self.lib, fn).restype = ctypes.c_int
        dev = torch.cuda.current_device()
        # pinned device memory (type 1) on this device (location type 1), read-write (3)
        self.prop, self.access = Prop(1, 0, Loc(1, dev)), Access(Loc(1, dev), 3)
        self.numel, self.dtype = numel, dtype
        self.nbytes = numel * torch.finfo(dtype).bits // 8

    def _cu(self, fn, *args):
        rc = getattr(self.lib, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"Guarded: {fn} returned libcuda error {rc}")

    def __enter__(self):
        c = self.c
        torch.cuda.synchronize()  # torch's context is current on this thread
        gran = c.c_size_t()
        self._cu("cuMemGetAllocationGranularity", c.byref(gran), c.byref(self.prop), 0)
        self.gran = gran.value
        self.size = -(-self.nbytes // self.gran) * self.gran
        ptr, handle = c.c_uint64(), c.c_uint64()
        self._cu("cuMemAddressReserve", c.byref(ptr), self.size + self.gran, 0, 0, 0)
        self.ptr = ptr.value
        self._cu("cuMemCreate", c.byref(handle), self.size, c.byref(self.prop), 0)
        self.handle = handle.value
        self._cu("cuMemMap", self.ptr, self.size, 0, self.handle, 0)
        self._cu("cuMemSetAccess", self.ptr, self.size, c.byref(self.access), 1)
        self.end = self.ptr + self.size  # the first unmapped byte
        return device_tensor(self.end - self.nbytes, self.numel, self.dtype)

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._cu("cuMemUnmap", self.ptr, self.size)
        self._cu("cuMemRelease", self.handle)
        self._cu("cuMemAddressFree", self.ptr, self.size + self.gran)


def guard_probe() -> int:
    """The guard's control, run in a process of its own: K4's three-part
    form (which reads all of a round's edge products) at the cylinder, f32,
    on a full-length row view that starts a defer-form row's length before
    the unmapped granule, so its last two products lie past the mapped
    memory.  A working guard makes K4's bulk copies fault, so this raises;
    returning 0 means the guard let the copies through."""
    *_, t = cylinder()
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = bwd_inputs(t, torch.float32, gen, processor(3))
    dagg = torch.zeros((t.num_nodes, LATENT), device="cuda")
    n = x["ws_defer"].numel()
    with Guarded(n, torch.float32) as ws:
        ws.copy_(x["ws_defer"])
        full = device_tensor(ws.data_ptr(), x["ws_e"].numel(), torch.float32)
        F.edge_round_bwd(x["de"].clone(), dagg, x["e0"], x["p"], x["q"], t.senders,
                         t.receivers, x["ev"], x["em"], full)
        torch.cuda.synchronize()
    return 0


def guarded_defer_round(t, proc) -> dict:
    """K4's defer form at the cylinder, f32 and bf16, on round 0's row of the
    defer_first form's edge stream copied into a Guarded buffer (the row's
    last byte the last mapped byte), against the same row in ordinary
    memory: a copy K4's ring made past the row would fault; the outputs
    must be the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = bwd_inputs(t, dtype, gen, proc)
        dagg = torch.randn((t.num_nodes, LATENT), generator=gen, device="cuda")
        outs = []
        for guard in (False, True):
            de = x["de"].clone()
            args = (dagg, x["e0"], x["p"], x["q"], t.senders, t.receivers, x["ev"], x["em"])
            if guard:
                with Guarded(x["ws_defer"].numel(), dtype) as ws:
                    ws.copy_(x["ws_defer"])
                    saved = F.edge_round_bwd(de, *args, ws, defer=True)
                    torch.cuda.synchronize()  # a read past the row would fault here
                    outs.append([de, *saved.dh, *saved.post, saved.ln])
            else:
                saved = F.edge_round_bwd(de, *args, x["ws_defer"], defer=True)
                outs.append([de, *saved.dh, *saved.post, saved.ln])
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"K4 defer {dtype}: the guarded stream row gave other bits")
        res[str(dtype)[6:]] = x["ws_defer"].numel() * x["ws_defer"].element_size()
        log(f"  K4 defer {dtype}: the defer stream's row ({res[str(dtype)[6:]]} bytes) ending at "
            "an unmapped granule, no fault, the same bits as in ordinary memory")
    return res


def guard_control() -> str:
    """Runs guard_probe in a process of its own, which must fail with an
    illegal address (K4's three-part form reading past a guarded row);
    returns the error line it printed."""
    run = subprocess.run([sys.executable, "-c", "import chip_smoke as c; "
                          "raise SystemExit(c.guard_probe())"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=300)
    lines = [ln for ln in (run.stdout + run.stderr).splitlines() if "illegal" in ln]
    if run.returncode == 0 or not lines:
        raise AssertionError("the guard's control: K4's three-part form read past a guarded "
                             f"row without a fault (exit {run.returncode}): {run.stderr[-500:]}")
    log(f"  guard control: K4's three-part form on a row whose last two products lie past "
        f"the mapped memory faulted in its own process (exit {run.returncode}: "
        f"{lines[-1].strip()[:120]})")
    return lines[-1].strip()


def phase_weight_streams(t, proc) -> dict:
    """The weight-stream layout kernel bit for bit against its plain version
    in every form (serving, adjoint, defer), f32 and bf16, latents 32, 64,
    128 and 256, 1-3 hidden layers, 1 and 15 rounds, both MLPs and each
    alone (one launch each); K4's defer form on a guarded row of the defer
    stream; the guard's control."""
    log("phase weight streams")
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for L in (32, 64, 128, 256):
            for hidden in (1, 2, 3):
                for rounds in (1, 15):
                    em, nm = stream_mlps(L, hidden, rounds, dtype)
                    for form, (adjoint, defer) in WS_FORMS.items():
                        for mlps in ((em, nm), (em, None), (None, nm)):
                            got = F.weight_streams(*mlps, adjoint, defer)
                            want = F.weight_streams_plain(*mlps, adjoint, defer)
                            for a, b in zip(got, want):
                                if (a is None) != (b is None) or (
                                        a is not None and not torch.equal(as_bits(a), as_bits(b))):
                                    raise AssertionError(
                                        f"weight_streams {form} {dtype} L {L}, {hidden} hidden, "
                                        f"{rounds} rounds, MLPs {[m is not None for m in mlps]}: "
                                        "differ from their plain version")
                            checked += 1
    log(f"  {checked} launches (every form, f32 and bf16, L 32-256, 1-3 hidden layers, 1 and "
        "15 rounds, both MLPs and each alone): the bits of weight_streams_plain")
    return dict(checked=checked, guarded=guarded_defer_round(t, proc), control=guard_control())


def primed_ms(fn, iters: int = 200) -> float:
    """Device ms a call over ``iters`` back-to-back calls by CUDA events, the
    device held by a spin kernel while the host queues them all, so the
    host's rate does not set the time (each launch's gap on the device is
    in it).  Raises if the spin ended before the host had queued them."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(int(4 * host * 2e9))  # about 4x the queueing time at up to 2 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    queued = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if spin.elapsed_time(start) < queued:
        raise RuntimeError(f"primed_ms: the spin ({spin.elapsed_time(start):.3f} ms) ended "
                           f"before the host had queued {iters} calls ({queued:.3f} ms)")
    return start.elapsed_time(end) / iters


def ws_time() -> int:
    """``--ws-time``: weight_streams alone, every form a tree has — at the
    cylinder (latent 128, 2 hidden layers, 15 rounds) serving, adjoint and
    defer (the defer_first form), f32 and bf16; the cloth trainer's
    one-round call (the flag's widths, f32) in the adjoint and defer forms
    — each held against its plain version first, then timed over 200
    launches: device ms a launch by CUDA events with the launches queued
    behind a spin kernel (primed_ms) and the kernel's mean duration by the
    profiler; beside it the form's bytes (every stream written once, from
    _stream_sizes; the cast weights read once), its bound at 3.35 TB/s and
    a device copy that moves the same bytes (dst.copy_(src), src and dst
    half of them each), timed the same two ways, as the practical floor.
    It uses only names the port has had since K8's stream (forms a tree
    lacks are left out), so copied into a checkout of an earlier commit it
    times that commit's kernel: run parent, change, change, parent in one
    call to compare both on one card.  One JSON line, ``ws-time:``, with
    the card's name and power limit."""
    import inspect

    from mgn_tpu_torch.probes import card

    _build.build_all(["fused_round"])
    has_defer = "defer" in inspect.signature(F.weight_streams).parameters
    res = {"card": card()}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        em, nm = stream_mlps(LATENT, HIDDEN, MPS, dtype, seed=3)
        cases += [(f"cylinder {form} {str(dtype)[6:]}", em, nm, form) for form in WS_FORMS]
    em, nm = stream_mlps(LATENT, HIDDEN, 1, torch.float32, seed=3)
    cases += [(f"cloth one round {form} float32", em, nm, form) for form in ("adjoint", "defer")]
    for label, em, nm, form in cases:
        adjoint, defer = WS_FORMS[form]
        if defer and not has_defer:
            continue
        kw = {"defer": True} if defer else {}
        call = lambda: F.weight_streams(em, nm, adjoint, **kw)
        for a, b in zip(call(), F.weight_streams_plain(em, nm, adjoint, **kw)):
            if not torch.equal(as_bits(a), as_bits(b)):
                raise AssertionError(f"ws-time {label}: differs from the plain version")
        dtype, L, rounds = em["w"][0].dtype, em["w"][0].shape[-1], em["w"][0].shape[0]
        b = torch.finfo(dtype).bits // 8
        sizes = F._stream_sizes(L, dtype, len(em["w"]), len(nm["w"]), adjoint, **kw)
        written = rounds * sum(sizes) * b
        read = sum(w.numel() for w in em["w"] + nm["w"]) * b
        src = torch.empty(((written + read) // 2,), dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        copy = lambda: dst.copy_(src)
        res[label] = dict(
            ms=primed_ms(call), kernel_ms=device_ms(call, 200, match="weight_streams_kernel",
                                                    kernels=1),
            written_mb=written / 1e6, read_mb=read / 1e6,
            bound_ms=(written + read) / PEAK_BYTES * 1e3,
            copy_ms=primed_ms(copy), copy_kernel_ms=device_ms(copy, 200, match="Memcpy"))
        log(f"  {label}: {json.dumps(res[label])}")
    log("ws-time: " + json.dumps(res))
    return 0


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
    """One round's MLP, each value once: the weights (the adjoint products'
    W^T holds the same values as the forward's W), biases, LN."""
    return (parts + HIDDEN) * LATENT * LATENT * b + (HIDDEN + 1) * LATENT * b + 2 * LATENT * 4


def bwd_inputs(t, dtype, gen, proc):
    v0, e0, ev = processor_inputs(t, dtype, gen)
    rnd = lambda rows: torch.randn((rows, LATENT), generator=gen, device="cuda").to(dtype)
    em_all = F.cast_mlp(proc["edge_mlp"], dtype)
    nm_all = F.cast_mlp(proc["node_mlp"], dtype)
    # K4's and K5's weights: round 0 of the streams a differentiated forward makes,
    # in the three-part form and in the defer_first form (K4's last two products cut)
    ws_e, ws_n, ws_p = (x[0] for x in F.weight_streams(em_all, nm_all, adjoint=True))
    ws_defer = F.weight_streams(em_all, adjoint=True, defer=True)[0][0]
    em = F.round_params(em_all, 0)
    # K4 reads K7's projections of the round's v, as the backward makes them
    # (K7's part of the projection row; K8's follows it)
    size_p = F._stream_sizes(LATENT, dtype, 0, 0)[2]
    p, q = F.edge_project(v0, em, ws_p[:size_p])
    return dict(v0=v0, e0=e0, ev=ev, agg=rnd(t.num_nodes), dv=rnd(t.num_nodes),
                de=rnd(t.num_edges), em=em, nm=F.round_params(nm_all, 0), ws_e=ws_e,
                ws_defer=ws_defer, ws_n=ws_n, ws_k8=ws_p[size_p:], p=p, q=q)


def wgrad_library(saved, inputs, deferred=()):
    """The gradients of one MLP round from one PyTorch call each
    (index_select, torch.matmul, sum), in the order of mlp_wgrads' outputs:
    every dW, every db, then the LayerNorm [scale | bias] gradients;
    ``deferred``'s (x, G) add W0's next row blocks as x^T G.  A yardstick
    for K6; the port never calls it."""
    dh = [d.float() for d in saved.dh]
    xs = [(x if idx is None else x.index_select(0, idx)).float() for x, idx in inputs]
    dws = [torch.cat([torch.matmul(x.t(), dh[0]) for x in xs]
                     + [torch.matmul(x.float().t(), g) for x, g in deferred])]
    dws += [torch.matmul(saved.post[i - 1].float().t(), dh[i]) for i in range(1, len(dh))]
    return dws + [d.sum(0) for d in dh] + [saved.ln.sum(0)]


def relu_input_errors(t, x, saved, mlp="em"):
    """The ReLU outputs K4 (``mlp`` "em") or K5 ("nm") recomputed, or those
    of its plain version (cuBLAS), as relative L2 distance to the same
    forward in f64, per hidden layer."""
    d = lambda a: a.double()
    w, b = x[mlp]["w"], x[mlp]["b"]
    parts = ((x["e0"], x["v0"][t.senders.long()], x["v0"][t.receivers.long()]) if mlp == "em"
             else (x["v0"], x["agg"]))
    h = sum(d(p) @ d(w[0][i * LATENT:(i + 1) * LATENT]) for i, p in enumerate(parts)) + d(b[0])
    errs = []
    for i in range(1, len(w)):
        h = torch.relu(h)
        errs.append(float((d(saved.post[i - 1]) - h).norm() / h.norm()))
        h = h @ d(w[i]) + d(b[i])
    return errs


def run_bwd_round(t, x, dtype, label):
    """K5 then K4 on one round against their plain versions; returns the
    errors and the plain outputs."""
    dv = x["dv"].clone()
    dagg, saved_n = F.node_round_bwd(dv, x["v0"], x["agg"], x["nm"], x["ws_n"])
    ref_dv, ref_dagg, ref_n = F.node_round_bwd_plain(x["dv"], x["v0"], x["agg"], x["nm"])
    de = x["de"].clone()
    dvs, dvr, saved_e = F.edge_round_bwd(de, ref_dagg, x["e0"], x["p"], x["q"], t.senders,
                                         t.receivers, x["ev"], x["em"], x["ws_e"])
    ref_de, ref_dvs, ref_dvr, ref_e = F.edge_round_bwd_plain(
        x["de"], ref_dagg, x["e0"], x["p"], x["q"], t.senders, t.receivers, x["ev"], x["em"])
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
    defer = run_defer_round(t, x, dtype, label, ref_dagg, de, saved_e)
    relu = None
    if dtype == torch.float32:
        relu = {k: {"kernel": relu_input_errors(t, x, got, m),
                    "plain": relu_input_errors(t, x, ref, m)}
                for k, m, got, ref in (("K4", "em", saved_e, ref_e), ("K5", "nm", saved_n, ref_n))}
        for k, r in relu.items():
            log(f"  {k} {label} recomputed ReLU outputs, relative L2 to an f64 forward: kernel "
                f"{r['kernel']}, plain version (cuBLAS f32) {r['plain']}")
    return k4, k5, ref_dvs, ref_e, relu, defer


def dh0_sums(t, dh0):
    """K1 and K1-perm on a round's dh0: ``(G_s, G_r)``, f32 (N, L)."""
    g_r = csr_segment_sum(dh0, t.receivers, t.row_offsets, t.num_nodes)
    g_s = csr_segment_sum(dh0, t.senders, t.sender_offsets, t.num_nodes, perm=t.sender_perm)
    return g_s, g_r


def run_defer_round(t, x, dtype, label, dagg, de3, saved3) -> dict:
    """The defer_first form of one round: K4's defer form on the shortened
    stream against its plain version, and the bits of the three-part
    kernel's de and MlpSaved (the form drops the last two products only)
    and of the defer form on the full stream's row cut to the same length;
    K1 and K1-perm on the plain dh0;
    K8 against its plain version, two calls the same bits; K6's N-row
    first-layer products (x^T G, G f32; bf16: the mixed form) against
    wgrad_plain."""
    runs = []
    for ws in (x["ws_defer"], x["ws_e"][:x["ws_defer"].numel()]):
        de = x["de"].clone()
        saved = F.edge_round_bwd(de, dagg, x["e0"], x["p"], x["q"], t.senders, t.receivers,
                                 x["ev"], x["em"], ws, defer=True)
        runs.append((de, saved))
    (de, saved), (de_full, saved_full) = runs
    ref_de, ref = F.edge_round_bwd_plain(x["de"], dagg, x["e0"], x["p"], x["q"], t.senders,
                                         t.receivers, x["ev"], x["em"], defer=True)
    torch.cuda.synchronize()
    k4 = max(check_bwd(f"K4 defer {label} de", dtype, de, ref_de)[0],
             check_saved(f"K4 defer {label}", dtype, saved, ref))
    outs = lambda d, m: [d, *m.dh, *m.post, m.ln]
    same = all(torch.equal(a, b) for a, b in zip(outs(de, saved), outs(de3, saved3)))
    if not same:
        raise AssertionError(f"K4 defer {label} {dtype}: de or MlpSaved differ from the "
                             "three-part form's bits")
    if not all(torch.equal(a, b) for a, b in zip(outs(de, saved), outs(de_full, saved_full))):
        raise AssertionError(f"K4 defer {label} {dtype}: the shortened stream and the full "
                             "one's leading part give different bits")
    g_s, g_r = dh0_sums(t, ref.dh[0])
    runs = []
    for _ in range(2):
        dv = x["dv"].clone()
        F.first_layer_adjoint(dv, g_s, g_r, x["em"], x["ws_k8"])
        runs.append(dv)
    ref_dv = F.first_layer_adjoint_plain(x["dv"], g_s, g_r, x["em"])
    torch.cuda.synchronize()
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"K8 {label} {dtype}: two calls gave different bits")
    k8 = check_bwd(f"K8 {label} dv", dtype, runs[0], ref_dv)[0]
    L = LATENT
    dw = torch.empty((2 * L, L), device="cuda")
    F.wgrad_group([F.WgradProduct(g_s, [(x["v0"], None)], dw[:L]),
                   F.WgradProduct(g_r, [(x["v0"], None)], dw[L:])])
    ref_w = torch.cat([F.wgrad_plain(g, x["v0"])[0] for g in (g_s, g_r)])
    exact = torch.cat([x["v0"].double().t() @ g.double() for g in (g_s, g_r)])
    torch.cuda.synchronize()
    k6 = check_bwd(f"K6 N-row products {label}", torch.float32, dw, ref_w)[0]
    k6_exact = float((dw.double() - exact).norm() / exact.norm())
    if not k6_exact <= 1e-5:  # f32 x f32: G is never rounded to the compute dtype
        raise AssertionError(f"K6 N-row products {label} {dtype}: relative L2 {k6_exact:.3e} "
                             "from the f64 product")
    log(f"  K4 defer {label} {dtype}: max_abs_err {k4:.3e}, de and MlpSaved the three-part "
        f"kernel's bits {same}, on the shortened and the full stream alike; K8: max_abs_err {k8:.3e}, two calls the same bits; K6 N-row "
        f"products ({'mixed bf16 x, f32 G' if dtype == torch.bfloat16 else 'f32'}): "
        f"max_abs_err {k6:.3e}, relative L2 to the f64 product {k6_exact:.3e}")
    return dict(k4=k4, k8=k8, k6_rows=k6, k6_rows_rel_f64=k6_exact, g_s=g_s, g_r=g_r)


def phase_backward(t, t20k, proc, t_flag):
    log("phase K4/K5/K6/K1-perm")
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_pad, e_pad, L = t.num_nodes, t.num_edges, LATENT
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        b = torch.finfo(dtype).bits // 8
        x = bwd_inputs(t, dtype, gen, proc)
        k4_err, k5_err, dvs, saved_e, relu, dfr = run_bwd_round(t, x, dtype, "cylinder")
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
        hold_k1(f"perm on the plain dvs {dtype}", dvs, t.senders, t.sender_offsets, n_pad,
                t.sender_perm)
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
            f"2(deg-1)u sum|x| of the card's plain version; the CPU plain version's bits); "
            f"K6 {dtype}: max_abs_err {k6_err:.3e}")

        # times at the cylinder shapes (the copies that reset the carries are
        # left out of the kernels' device time by name)
        # device kernels per wrapper call (kpc) counted from the same profiles
        k5_ms, k5_kpc = device_time(lambda: F.node_round_bwd(
            x["dv"].clone(), x["v0"], x["agg"], x["nm"], x["ws_n"]), match="node_round_bwd",
            kernels=1)
        k5_plain = device_ms(lambda: F.node_round_bwd_plain(x["dv"], x["v0"], x["agg"], x["nm"]))
        # K5 behind a 64 MB fill, which evicts its weights and inputs from
        # the 50 MB L2 as a training step's other kernels do (PERF.md §7)
        flush = torch.empty((16 * 2 ** 20,), device="cuda")
        k5_cold = device_ms(lambda: (flush.zero_(), F.node_round_bwd(
            x["dv"].clone(), x["v0"], x["agg"], x["nm"], x["ws_n"])), match="node_round_bwd",
            kernels=1)
        del flush
        k4_ms, k4_kpc = device_time(lambda: F.edge_round_bwd(x["de"].clone(), ref_b.new_zeros(
            (n_pad, L)), x["e0"], x["p"], x["q"], t.senders, t.receivers, x["ev"], x["em"],
            x["ws_e"]), match="edge_round_bwd", kernels=1)
        zeros_agg = torch.zeros((n_pad, L), device="cuda")
        k4_plain = device_ms(lambda: F.edge_round_bwd_plain(
            x["de"], zeros_agg, x["e0"], x["p"], x["q"], t.senders, t.receivers, x["ev"],
            x["em"]))
        # the defer_first form: K4 without dvs/dvr, K8, K6's N-row products
        k4d_ms, k4d_kpc = device_time(lambda: F.edge_round_bwd(
            x["de"].clone(), zeros_agg, x["e0"], x["p"], x["q"], t.senders, t.receivers,
            x["ev"], x["em"], x["ws_defer"], defer=True), match="edge_round_bwd", kernels=1)
        k4d_plain = device_ms(lambda: F.edge_round_bwd_plain(
            x["de"], zeros_agg, x["e0"], x["p"], x["q"], t.senders, t.receivers, x["ev"],
            x["em"], defer=True))
        g_s, g_r = dfr["g_s"], dfr["g_r"]
        k8_ms, k8_kpc = device_time(lambda: F.first_layer_adjoint(
            x["dv"].clone(), g_s, g_r, x["em"], x["ws_k8"]), 200, match="first_layer_adjoint",
            kernels=1)
        k8_plain = device_ms(lambda: F.first_layer_adjoint_plain(x["dv"], g_s, g_r, x["em"]),
                             200)
        dw_rows = torch.empty((2 * L, L), device="cuda")
        rows_group = [F.WgradProduct(g_s, [(x["v0"], None)], dw_rows[:L]),
                      F.WgradProduct(g_r, [(x["v0"], None)], dw_rows[L:])]
        k6n_ms, k6n_kpc = device_time(lambda: F.wgrad_group(rows_group), 200, match="wgrad",
                                      kernels=1)
        k6n_plain = device_ms(lambda: [F.wgrad_plain(g, x["v0"]) for g in (g_s, g_r)], 200)
        perm_ms, perm_kpc = device_time(lambda: csr_segment_sum(
            dvs, t.senders, t.sender_offsets, n_pad, perm=t.sender_perm), 200,
            match="csr_segment_sum", kernels=1)
        perm_plain = device_ms(lambda: csr_segment_sum_plain(
            dvs, t.senders, t.sender_offsets, n_pad, perm=t.sender_perm), 200)
        k6_ms, k6_kpc = device_time(lambda: F.wgrad(dh0, x["e0"], None, dw=dw, db=db), 200,
                                    match="wgrad", kernels=1)
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
        # the defer_first form's edge group: the e part against dh0, W0's
        # sender and receiver rows as N-row products v^T G
        deferred = [(x["v0"], dfr["g_s"]), (x["v0"], dfr["g_r"])]
        rounds = {"edge": (saved_e, edge_in, ()), "node": (saved_n, node_in, ()),
                  "edge_defer": (saved_e, edge_in[:1], deferred)}
        grads["edge_defer"] = grads["edge"]
        k6r = {}
        for m, (saved, inputs, dfd) in rounds.items():
            before = F.wgrad.launches
            F.mlp_wgrads(saved, inputs, grads[m], 0, deferred=dfd)
            if F.wgrad.launches != before + 1:
                raise AssertionError("mlp_wgrads is not one grouped K6 call")
            ref = wgrad_library(saved, inputs, dfd)
            torch.cuda.synchronize()
            got = [g[0] for g in grads[m]["w"]] + [g[0] for g in grads[m]["b"]] + [
                torch.cat([grads[m]["ln_scale"][0], grads[m]["ln_bias"][0]])]
            k6r[f"{m}_max_abs_err"] = max(check_bwd(f"K6 {m} round {i}", torch.float32, a, b)[0]
                                          for i, (a, b) in enumerate(zip(got, ref)))
            k6r[f"{m}_ms"], k6r[f"{m}_kernels_per_call"] = device_time(
                lambda: F.mlp_wgrads(saved, inputs, grads[m], 0, deferred=dfd), 50,
                match="wgrad", kernels=1)
            if dtype == torch.float32:
                k6r[f"{m}_library_ms"] = device_ms(lambda: wgrad_library(saved, inputs, dfd), 50)
        lib = {}
        if dtype == torch.float32:
            idx = t.senders.long()
            zero = torch.zeros((n_pad, L), device="cuda")
            lib["perm"] = device_ms(lambda: zero.index_add(0, idx, dvs), 200)
            lib["wgrad"] = device_ms(lambda: torch.matmul(x["e0"].t(), dh0), 200)
            # K8's product as one f32 matmul: [G_s | G_r] (N, 2L) by [W_s^T; W_r^T] (2L, L)
            g_cat = torch.cat([g_s, g_r], dim=1)
            w_cat = torch.cat([x["em"]["w"][0][p * L:(p + 1) * L].t() for p in (1, 2)]).float()
            lib["k8"] = device_ms(lambda: torch.matmul(g_cat, w_cat), 200)
            # K6's N-row products as one: v^T [G_s | G_r]
            v32 = x["v0"].float()
            lib["k6_rows"] = device_ms(lambda: torch.matmul(v32.t(), g_cat), 200)
        # bounds: each input read once, each output written once; operations
        # (1 + H) L^2 MACs per edge for the pre-projected recompute and
        # (H + 3) L^2 for the adjoint, as FLOP; K4 reads the f32 P and Q
        k4_ops = 2 * (4 + 2 * HIDDEN) * L * L * e_pad
        k4_bytes = ((2 * e_pad * L + e_pad) * b + 3 * n_pad * L * 4 + 2 * e_pad * 4
                    + weight_bytes(3, b)
                    + (3 + HIDDEN + 1 + HIDDEN) * e_pad * L * b
                    + -(-e_pad // F._EDGE_BWD_ROWS) * 2 * L * 4)
        # the defer form: 2 products fewer, no dvs/dvr, W0's e block alone
        k4d_ops = 2 * (2 + 2 * HIDDEN) * L * L * e_pad
        k4d_bytes = ((2 * e_pad * L + e_pad) * b + 3 * n_pad * L * 4 + 2 * e_pad * 4
                     + weight_bytes(1, b) + (1 + HIDDEN + 1 + HIDDEN) * e_pad * L * b
                     + -(-e_pad // F._EDGE_BWD_ROWS) * 2 * L * 4)
        # K8: G_s, G_r read, dv read and written, W0's two row blocks
        k8_ops = 2 * 2 * L * L * n_pad
        k8_bytes = 2 * n_pad * L * 4 + 2 * n_pad * L * b + 2 * L * L * b
        # K6's N-row products: v and G_s, G_r read, dW0's two row blocks written
        k6n_ops = 2 * 2 * n_pad * L * L
        k6n_bytes = n_pad * L * b + 2 * n_pad * L * 4 + 2 * L * L * 4
        k5_ops = 2 * 2 * (2 + HIDDEN) * L * L * n_pad
        k5_nbytes = k5_bytes(n_pad, b, False)
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
            "node_round_bwd": (k5_err, k5_ms, k5_plain, *bound_ms(k5_nbytes, k5_ops, dtype), None,
                               k5_kpc),
            "csr_segment_sum_perm": (float(perm_err.max()), perm_ms, perm_plain,
                                     *bound_ms(perm_bytes, e_pad * L, torch.float32),
                                     lib.get("perm"), perm_kpc),
            "wgrad": (k6_err, k6_ms, k6_plain, *bound_ms(k6_bytes, k6_ops, torch.float32),
                      lib.get("wgrad"), k6_kpc),
            "edge_round_bwd_defer": (dfr["k4"], k4d_ms, k4d_plain,
                                     *bound_ms(k4d_bytes, k4d_ops, dtype), None, k4d_kpc),
            "first_layer_adjoint": (dfr["k8"], k8_ms, k8_plain,
                                    *bound_ms(k8_bytes, k8_ops, torch.float32), lib.get("k8"),
                                    k8_kpc),
            "wgrad_node_rows": (dfr["k6_rows"], k6n_ms, k6n_plain,
                                *bound_ms(k6n_bytes, k6n_ops, torch.float32),
                                lib.get("k6_rows"), k6n_kpc),
        }
        res[dtype] = {k: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "device_launches_per_call"), v))
                      for k, v in entries.items()}
        res[dtype]["node_round_bwd"]["relu_input_rel_l2"] = relu and relu["K5"]
        res[dtype]["node_round_bwd"]["cold_l2_ms"] = k5_cold
        log(f"  node_round_bwd {dtype}: device {k5_cold:.5f} ms a call with a cold L2 (after a "
            f"64 MB fill), {k5_ms:.5f} warm")
        # the same bounds at the tensor-core rate of the units K4, K5 and K6 use
        # (K8 and K6's N-row products multiply f32 x f32 in both dtypes: 3xTF32)
        for name, nbytes, ops, dt in (("edge_round_bwd", k4_bytes, k4_ops, dtype),
                                      ("node_round_bwd", k5_nbytes, k5_ops, dtype),
                                      ("wgrad", k6_bytes, k6_ops, dtype),
                                      ("edge_round_bwd_defer", k4d_bytes, k4d_ops, dtype),
                                      ("first_layer_adjoint", k8_bytes, k8_ops, torch.float32),
                                      ("wgrad_node_rows", k6n_bytes, k6n_ops, torch.float32)):
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
                    f"{r['device_launches_per_call']} device kernels a call), plain "
                    f"{r['plain_ms']:.5f} ms, "
                    f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}"
                    + (f"; tensor cores {r['bound_tc_ms']:.5f} ms, {r['bound_tc_by']}"
                       if "bound_tc_ms" in r else "") + f"), library {r['library_ms']}")
        w = res[dtype]["wgrad_round"]
        log(f"  K6 edge group in the defer_first form {dtype}: {w['edge_defer_ms']:.5f} ms "
            f"(three-part {w['edge_ms']:.5f}), max_abs_err {w['edge_defer_max_abs_err']:.3e}, "
            f"library route {w.get('edge_defer_library_ms')}, first-layer products "
            f"{2 * e_pad * L * L / 1e9 + 2 * 2 * n_pad * L * L / 1e9:.3f} GFLOP against "
            f"{3 * 2 * e_pad * L * L / 1e9:.3f}")
        log(f"  K6 over one round (2 grouped calls: edge {w['edge_ms']:.5f} ms, node "
            f"{w['node_ms']:.5f} ms; device kernels a call: edge {w['edge_kernels_per_call']:g}, "
            f"node {w['node_kernels_per_call']:g}) {dtype}: device {w['ms']:.5f} ms, library route "
            f"{w['library_ms']}, bound {w['bound_ms']:.5f} ms ({w['bound_by']}; tensor cores "
            f"{w['bound_tc_ms']:.5f} ms, {w['bound_tc_by']}; {w['gflop']:.3f} GFLOP, "
            f"{w['mbytes']:.1f} MB)")
        if dtype == torch.float32 and not w["ms"] < w["library_ms"]:
            log("  note: K6 per round is not below the library route in this run")
    # P6: the same kernels on a mesh ten times larger, and at the flag's shapes
    for dtype in (torch.float32, torch.bfloat16):
        for tt, label in ((t20k, f"20k-node mesh (E_pad {t20k.num_edges})"),
                          (t_flag, f"flag (N_pad {t_flag.num_nodes}, E_pad {t_flag.num_edges})")):
            run_bwd_round(tt, bwd_inputs(tt, dtype, gen, proc), dtype, label)
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
                                         t.num_nodes, preproject=True)
            return torch.autograd.grad((out.float() ** 2).sum(), [v0, e0, *leaves])

        # the backward's own rule (E >= N: the defer_first form), then its
        # three-part form pinned (what it runs at E < N), each twice
        ref = plain()
        forms = {}
        for defer in (None, False):
            F._FORCE_DEFER = defer
            try:
                reset_counts()
                got = kernels()
                counts = read_counts()
                again = kernels()  # fixed-order sums only: the same bits on every pass
            finally:
                F._FORCE_DEFER = None
            torch.cuda.synchronize()
            form = "three-part" if defer is False else "defer_first"
            want = ({"edge_round_bwd": MPS, "edge_round_bwd_defer": 0, "first_layer_adjoint": 0}
                    if defer is False else
                    {"edge_round_bwd": 0, "edge_round_bwd_defer": MPS, "first_layer_adjoint": MPS})
            if counts["node_round_bwd"] != MPS or any(counts[k] != n for k, n in want.items()):
                raise AssertionError(f"the {form} gradient did not run its backward kernels: "
                                     f"{counts}")
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"  two backward passes, {form} form, {dtype}: gradients bit-identical {same}")
            if not same:
                raise AssertionError(f"two backward passes gave different gradients ({dtype}, "
                                     f"{form})")
            if got[1][~t.edge_mask].any():
                raise AssertionError("a dead edge's latent got a gradient")
            forms[form] = (got, counts, check_grads(
                f"fused_process gradient, {MPS} rounds, {form} form", dtype, got, ref))
        got, counts, res[dtype] = forms["defer_first"]
        res[dtype]["bit_identical"] = True
        res[dtype]["three_part"] = forms["three-part"][2]
        res[dtype]["three_part_launches"] = forms["three-part"][1]
        res[dtype]["three_part_vs_defer_first"] = dict(zip(
            ("share_outside", "rel_l2", "max_abs_err"), grad_stats(forms["three-part"][0], got)))
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
ACCURACY_SEEDS = (7, 8)  # four seeds until the graph-parallel phase took their time


def gradient_accuracy(t, seed: int, mps: int) -> dict:
    """One f32 gradient of ``mps`` processor rounds at weights and inputs
    from ``seed``, as distances (worst leaf) between: the kernels and
    autograd of process_rounds_plain; each of the two and autograd of
    process_rounds_f64; and the plain path and a second run of itself, whose
    scatter-adds (atomics) sum in another order — the distance that the
    summation order alone makes through ReLU ties.  "kernels" is the
    backward's defer_first form (its rule at E >= N), "kernels_three_part"
    its three-part form, pinned.  Reported, with whether the kernels are
    within the whole-gradient tolerance of the plain path; the fatal check
    is phase_processor_grad's (section 6 of PERF.md)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    proc = processor(seed)
    v0, e0, ev = processor_inputs(t, torch.float32, gen)
    grads = {}
    for path in ("kernels", "kernels_three_part", "plain", "plain_again", "f64"):
        dt = torch.float64 if path == "f64" else torch.float32
        p = grad_copy(proc, dtype=dt)
        v, e = (x.detach().to(dt).requires_grad_(True) for x in (v0, e0))
        if path.startswith("kernels"):
            F._FORCE_DEFER = False if path == "kernels_three_part" else None
            try:
                out = F.fused_process(p, v, e, t.senders, t.receivers, t.row_offsets, ev, mps,
                                      sender_perm=t.sender_perm, sender_offsets=t.sender_offsets)
                grads[path] = torch.autograd.grad((out ** 2).sum(), [v, e, *param_leaves(p)])
            finally:
                F._FORCE_DEFER = None
            continue
        if path == "f64":
            out = process_rounds_f64(p, v, e, t, mps)
        else:
            out = F.process_rounds_plain(p, v, e, t.senders, t.receivers, ev, mps,
                                         torch.float32, t.num_nodes, preproject=True)
        grads[path] = torch.autograd.grad((out ** 2).sum(), [v, e, *param_leaves(p)])
    res = {}
    for path, ref in (("kernels", "plain"), ("kernels", "f64"),
                      ("kernels_three_part", "f64"), ("kernels", "kernels_three_part"),
                      ("plain", "f64"), ("plain", "plain_again")):
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

def frame_loss_grads(params, norm, prep, t: int, cfg, spec, types_updated=(0, 5)):
    """One frame's loss and whole-model gradient, noise 0, normalizers as
    given (no accumulation): the trainer's loss on the trainer's inputs."""
    tcfg = DerivativeTrainerConfig(cfg, spec, (0.0,), types_updated=types_updated)
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


def profile_training(run, n: int) -> dict:
    """Device time by kernel and the device's idle share over ``run()``, ``n``
    training steps, from torch.profiler's CUDA activity (the profiler's host
    cost is in the wall time, so the idle share is an upper bound)."""
    names = ("edge_round_bwd", "node_round_bwd", "wgrad", "edge_project", "edge_round",
             "node_round", "weight_streams", "csr_segment_sum", "first_layer_adjoint")
    reset_counts()
    events, wall_ms = profiled(run)
    calls = read_counts()
    # one kernel serves each pair of wrapper forms
    for base, form in (("csr_segment_sum", "csr_segment_sum_perm"),
                       ("node_round", "node_round_extra"),
                       ("node_round_bwd", "node_round_bwd_extra"),
                       ("edge_round_bwd", "edge_round_bwd_defer")):
        calls[base] += calls.pop(form)
    groups = {k: 0.0 for k in names + ("other",)}
    kernels, other, total = dict.fromkeys(names, 0), {}, 0
    for ev in events:
        key = next((k for k in names if k in ev.name), "other")
        ms = ev.time_range.elapsed_us() / 1e3
        groups[key] += ms
        total += not is_copy(ev.name)
        if key == "other":
            other[ev.name[:60]] = other.get(ev.name[:60], 0.0) + ms / n
        elif not is_copy(ev.name):
            kernels[key] += 1
    busy = sum(groups.values())
    if busy == 0.0:
        log("  profile: the profiler recorded no device activity; device time not measured")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    per_call = {k: kernels[k] / calls[k] if calls[k] else None for k in names}
    # a kernel's device ms per launch inside the step (copies excluded)
    per_launch = {k: groups[k] / kernels[k] if kernels[k] else None for k in names}
    log(f"  profile of {n} training steps: wall {wall_ms / n:.3f} ms per step (profiler on), "
        f"device busy {busy / n:.3f} ms per step, idle share {1 - busy / wall_ms:.4f}; by "
        "kernel (ms per step): " + ", ".join(f"{k} {v / n:.3f} ({v / busy:.3f})"
                                             for k, v in groups.items()))
    log("  device kernels per step (per wrapper call), counted by the profiler: "
        + ", ".join(f"{k} {kernels[k] / n:g} ({per_call[k]})" for k in names)
        + f"; every device kernel (copies and fills left out) {total / n:g} a step")
    log("  device ms per kernel launch inside the step: "
        + ", ".join(f"{k} {v:.5f}" for k, v in per_launch.items() if v is not None))
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
    log("  largest other device activity (ms per step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in top.items()))
    return {"wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy / n,
            "idle_share": 1 - busy / wall_ms, "device_ms_per_step": {k: v / n for k, v in
                                                                   groups.items()},
            "device_kernels_per_step": {k: kernels[k] / n for k in names},
            "device_kernels_total_per_step": total / n,
            "other_top_ms_per_step": top,
            "device_kernels_per_call": per_call, "device_ms_per_launch": per_launch}


def projection_bits(step) -> dict:
    """One training ``step()`` with every K7 launch's outputs recorded: the
    forward projects each round's v, the backward projects each round's
    saved v again (in reverse round order), and the two must give the same
    bits, or K4's recompute would not see K2's first layer."""
    seen, launch = [], F._project_launch

    def record(v, wstream, p, q):
        launch(v, wstream, p, q)
        seen.append((p.clone(), q.clone()))

    F._project_launch = record
    try:
        step()
    finally:
        F._project_launch = launch
    torch.cuda.synchronize()
    if len(seen) != 2 * MPS:
        raise AssertionError(f"one training step ran K7 {len(seen)} times, expected {2 * MPS}")
    same = [torch.equal(seen[r][k], seen[2 * MPS - 1 - r][k]) for r in range(MPS)
            for k in range(2)]
    log(f"  one training step: the backward's K7 on each round's saved v gives the forward's "
        f"P and Q bit for bit: {sum(same)} of {len(same)}")
    if not all(same):
        raise AssertionError("the backward's projections differ from the forward's")
    return {"identical": sum(same), "of": len(same)}


def phase_training(workdir):
    log("phase training")
    ds, cp = os.path.join(workdir, "ds"), os.path.join(workdir, "cp_train")
    t0 = time.perf_counter()
    # the test trajectory (phase_eval's) is written after the others, which it leaves as
    # they were without it
    write_synthetic_tfrecord_dataset(ds, num_nodes=1900, tl=TRAIN["tl"], n_train=2, n_valid=1,
                                     n_test=1, seed=0)
    log(f"  wrote a 1,900-node channel-flow TFRecord dataset (2 train + 1 valid + 1 test "
        f"trajectories of {TRAIN['tl']} frames) in {time.perf_counter() - t0:.2f} s")
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
        if n <= 0 and name not in ("node_round_extra", "node_round_bwd_extra") + THREE_PART:
            raise AssertionError(f"{name} was not launched by train_network")
    if any(launches[k] for k in THREE_PART):  # E >= N: the backward takes defer_first
        raise AssertionError(f"train_network ran the three-part backward form: {launches}")
    if state.step != TRAIN["steps"] or len(valid) != 2 or not all(
            np.isfinite(r["loss"]) for r in train + valid):
        raise AssertionError(f"training did not run as set up: step {state.step}, "
                             f"{len(valid)} validation sweeps, losses {train + valid}")
    default_args = train_with_default_args(workdir)

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
    if per_step["edge_project"] != 2 * MPS:  # the forward's, then the backward's recompute
        raise AssertionError(f"{per_step['edge_project']} K7 calls per training step, "
                             f"expected {2 * MPS}")
    if per_step["edge_round_bwd_defer"] != MPS or per_step["first_layer_adjoint"] != MPS:
        raise AssertionError(f"K4's defer form {per_step['edge_round_bwd_defer']}, K8 "
                             f"{per_step['first_layer_adjoint']} calls per training step, "
                             f"expected {MPS} each")
    step_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    residual_mb = MPS * (2 * prep.template.num_nodes + prep.template.num_edges) * LATENT * 4 / 1e6
    log(f"  training step (forward + backward + Adam, noise 0.02): {step_ms:.3f} ms per step "
        f"over {len(perm)} steps; peak device memory {step_peak_mb:.1f} MiB; residual stacks "
        f"{residual_mb:.1f} MB per step; wrapper calls per step {per_step}")
    profile = profile_training(lambda: trainer(state, prep.template, prep.fields, prep.times,
                                               perm[:5], gen), 5)
    # the same steps with the backward's three-part form pinned (its form at
    # E < N): what the defer_first form changes, on this card in this run
    F._FORCE_DEFER = False
    try:
        log("  the same 5 steps with the backward's three-part form pinned:")
        profile_three = profile_training(lambda: trainer(state, prep.template, prep.fields,
                                                         prep.times, perm[:5], gen), 5)
    finally:
        F._FORCE_DEFER = None
    # after the peak memory is read: the check keeps a copy of every P and Q
    recompute = projection_bits(lambda: trainer(state, prep.template, prep.fields, prep.times,
                                                perm[:1], gen))
    if profile.get("device_kernels_per_step"):
        k6_kernels = profile["device_kernels_per_step"]["wgrad"]
        log(f"  K6 per training step: {per_step['wgrad']:.0f} wrapper calls, "
            f"{k6_kernels:g} device kernels")
        if round(k6_kernels) != round(per_step["wgrad"]):  # one launch a call
            raise AssertionError(f"K6: {k6_kernels:g} device kernels a step for "
                                 f"{per_step['wgrad']:g} calls")

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
                          default_args=default_args, profile_three_part=profile_three,
                          ms_per_step=step_ms, step_peak_mib=step_peak_mb,
                          residual_mb=residual_mb, profile=profile, grad_check=grad_check,
                          recompute_bits=recompute,
                          step_losses_rel_diff=rel, window_losses=[r["loss"] for r in train],
                          valid_losses=[r["loss"] for r in valid])


UNION = dict(batch=2, steps=20, norm_steps=10, checkpoint=20)  # one 20-frame window


def host_ops(run, n: int, top: int = 8) -> dict:
    """The host operations that take most of ``run()``'s ``n`` training steps
    (torch.profiler, CPU activity only: self CPU ms a step by operation),
    and the host ms a step in all (run ends in a copy to the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    wall = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:top]
    ops = {a.key[:60]: a.self_cpu_time_total / 1e3 / n for a in rows}
    log(f"  host ops, {n} steps (profiler on, CPU only: {wall:.3f} ms a step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ops.items()))
    return {"wall_ms_per_step": wall, "self_cpu_ms_per_step": ops}


def union_forward_bits(params, cfg, spec, norm, preps, union) -> dict:
    """The union's fused_process, given the subgraphs' encoded latents
    concatenated, against one fused_process a subgraph: every kernel output
    row depends on that row's inputs alone (K1 sums a row in its fixed
    order; K2, K3 and K7 compute per edge or per node), so bit for bit, f32
    and bf16.  Then the whole forward (apply_mgn) over the union against the
    subgraphs' forwards, to the serving tolerance (the encoders and the
    decoder are torch.matmul, which may take another algorithm for twice the
    rows)."""
    from mgn_tpu_torch.models.mlp import apply_mlp

    tm = union[0]
    graphs = [assemble_graph(norm, p.template, {f: p.fields[f][3] for f in spec.fields}, spec)
              for p in preps]
    ug = assemble_graph(norm, tm, {f: union[1][f][3] for f in spec.fields}, spec)
    out = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            def encoded(g):
                ev = g.edge_mask.to(dtype)[:, None]
                return (apply_mlp(params["node_encoder"], g.node_features, dtype),
                        apply_mlp(params["edge_encoder"], g.edge_features, dtype) * ev, ev)

            parts = [encoded(g) for g in graphs]
            singles = [F.fused_process(params["processor"], v, e, p.template.senders,
                                       p.template.receivers, p.template.row_offsets, ev, MPS)
                       for (v, e, ev), p in zip(parts, preps)]
            v0 = torch.cat([v for v, _, _ in parts])
            e0 = torch.cat([e for _, e, _ in parts])
            ev = torch.cat([x for _, _, x in parts])
            joint = F.fused_process(params["processor"], v0, e0, tm.senders, tm.receivers,
                                    tm.row_offsets, ev, MPS)
            n = preps[0].template.num_nodes
            same = [torch.equal(joint[i * n:(i + 1) * n], x) for i, x in enumerate(singles)]
            log(f"  union fused_process {dtype} (the subgraphs' encoded latents concatenated) "
                f"against one call a subgraph: bit for bit per subgraph {same}")
            if not all(same):
                d = max(float((joint[i * n:(i + 1) * n].float() - x.float()).abs().max())
                        for i, x in enumerate(singles))
                raise AssertionError(f"union fused_process {dtype}: not the per-graph bits "
                                     f"(max |diff| {d:.3e})")
            out[str(dtype)] = {"identical_subgraphs": sum(same)}
        pred = apply_mgn(params, ug, cfg, tm.row_offsets)
        refs = torch.cat([apply_mgn(params, g, cfg, p.template.row_offsets)
                          for g, p in zip(graphs, preps)])
    max_abs, rel = err_stats(pred, refs)
    check_tol("union apply_mgn against the subgraphs' forwards", torch.float32, max_abs, rel)
    out["forward"] = {"max_abs_err": max_abs, "rel_l2": rel}
    return out


def phase_union_training(workdir, single) -> dict:
    """train_network(batchsize=2) on phase_training's dataset: its two
    training trajectories as one disjoint-union graph a step (B·N_pad 3,840
    nodes, B·E_pad 22,528 edges), 20 steps at full width with one
    validation sweep; every kernel of the defer_first backward launched and
    no three-part K4.  Then the union step alone (ms per step, wrapper calls
    and profiler kernels a step, device busy and idle share beside the
    single-graph step's ``single``, peak memory), the union's fused_process
    against the per-graph calls, and one frame's whole-model gradient on the
    union against the CPU plain path."""
    from mgn_tpu_torch.data.union import union_prepared
    from mgn_tpu_torch.train.derivative import make_union_derivative_trainer

    log("phase union training")
    t_phase = time.perf_counter()
    ds, cp = os.path.join(workdir, "ds"), os.path.join(workdir, "cp_union")
    model = dict(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN)
    metrics = MetricsLogger(quiet=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, best = train_network(0.02, lambda ps: torch.optim.Adam(ps, lr=1e-4), ds, cp,
                                metrics=metrics, device=DEVICE, steps=UNION["steps"],
                                norm_steps=UNION["norm_steps"], checkpoint=UNION["checkpoint"],
                                batchsize=UNION["batch"], solver_valid="euler", seed=0, **model)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    train = [r for r in metrics.records if r["kind"] == "train"]
    valid = [r for r in metrics.records if r["kind"] == "valid"]
    log(f"  train_network(batchsize={UNION['batch']}): {state.step} steps "
        f"({UNION['norm_steps']} of warm-up), {len(valid)} validation sweep(s), {wall_s:.2f} s; "
        f"window losses {[round(r['loss'], 6) for r in train]}, validation losses "
        f"{[round(r['loss'], 6) for r in valid]}; peak device memory {peak_mb:.1f} MiB")
    log(f"  launches in train_network(batchsize={UNION['batch']}): {launches}")
    for name, n in launches.items():
        if n <= 0 and name not in ("node_round_extra", "node_round_bwd_extra") + THREE_PART:
            raise AssertionError(f"{name} was not launched by the union training")
    if any(launches[k] for k in THREE_PART):  # B·E >= B·N: the backward takes defer_first
        raise AssertionError(f"the union training ran the three-part backward form: {launches}")
    if state.step != UNION["steps"] or len(valid) != 1 or not all(
            np.isfinite(r["loss"]) for r in train + valid):
        raise AssertionError(f"union training did not run as set up: step {state.step}, "
                             f"{len(valid)} validation sweeps, losses {train + valid}")

    # the union step alone, past the warm-up
    dataset = load_dataset(ds)
    meta = dataset.meta
    cfg, spec = build_model_config(meta, Args(**model))
    nb, eb = common_buckets([dataset.structure(0)], meta, 128, 512)
    preps = [prepare_trajectory(dataset.trajectory(i), meta, spec, nb, eb, device=DEVICE)
             for i in range(UNION["batch"])]
    union = union_prepared(preps)
    tm, fields, times, info = union
    trash = [(i + 1) * info.nodes_per_graph - 1 for i in range(info.batch)]
    log(f"  union graph: B {info.batch}, B·N_pad {tm.num_nodes}, B·E_pad {tm.num_edges}, "
        f"real edges {int(tm.edge_mask.sum())}, trash rows at {trash} with "
        f"{[int(tm.row_offsets[r + 1] - tm.row_offsets[r]) for r in trash]} entries")
    trainer = make_union_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.02,),
                                                                    norm_steps=0),
                                            info.node_graph_ids())
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rng = np.random.default_rng(0)
    perms = np.stack([rng.permutation(TRAIN["tl"] - 1) for _ in range(info.batch)], 1)
    trainer(state, tm, fields, times, perms[:2], gen)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer(state, tm, fields, times, perms, gen)  # returns host losses
    step_ms = (time.perf_counter() - t0) * 1e3 / len(perms)
    per_step = {k: v / len(perms) for k, v in read_counts().items()}
    step_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if (per_step["edge_round_bwd_defer"] != MPS or per_step["first_layer_adjoint"] != MPS
            or per_step["edge_round_bwd"] != 0 or per_step["wgrad"] != 2 * MPS):
        raise AssertionError(f"union step: wrapper calls per step {per_step}")
    log(f"  union training step (B {info.batch}, forward + backward + Adam, noise 0.02): "
        f"{step_ms:.3f} ms per step over {len(perms)} steps (the single-graph step: "
        f"{single['ms_per_step']:.3f}); peak device memory {step_peak_mb:.1f} MiB (single "
        f"graph: {single['step_peak_mib']:.1f}); wrapper calls per step {per_step}")
    profile = profile_training(lambda: trainer(state, tm, fields, times, perms[:5], gen), 5)
    one = single["profile"]
    if profile.get("device_busy_ms_per_step") and one.get("device_busy_ms_per_step"):
        log(f"  device busy per step: union (B {info.batch}) "
            f"{profile['device_busy_ms_per_step']:.3f} ms, idle share "
            f"{profile['idle_share']:.4f}, {profile['device_kernels_total_per_step']:g} device "
            f"kernels; single graph {one['device_busy_ms_per_step']:.3f} ms, idle share "
            f"{one['idle_share']:.4f}, {one['device_kernels_total_per_step']:g} device kernels")

    single_trainer = make_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.02,),
                                                                     norm_steps=0))
    host = {"union": host_ops(lambda: trainer(state, tm, fields, times, perms[:5], gen), 5),
            "single": host_ops(lambda: single_trainer(state, preps[0].template,
                                                      preps[0].fields, preps[0].times,
                                                      list(perms[:5, 0]), gen), 5)}
    bits = union_forward_bits(state.params, cfg, spec, state.norm, preps, union)
    # one frame of each subgraph: the whole-model gradient on the card against the CPU
    t_nodes = torch.as_tensor(np.array([3, 11]), device=DEVICE)[
        torch.as_tensor(info.node_graph_ids(), device=DEVICE)]
    uprep = type(preps[0])(tm, fields, times, sum(p.num_nodes for p in preps), TRAIN["tl"])
    loss_g, g_gpu = frame_loss_grads(grad_copy(state.params), state.norm, uprep, t_nodes,
                                     cfg, spec)
    loss_c, g_cpu = frame_loss_grads(grad_copy(state.params, "cpu"), state.norm.to("cpu"),
                                     to_cpu_prep(uprep), t_nodes.cpu(), cfg, spec)
    log(f"  union frame loss: {DEVICE} {float(loss_g.detach()):.7f}, cpu "
        f"{float(loss_c.detach()):.7f}")
    grad_check = check_grads("union whole-model gradient, cuda vs cpu plain path",
                             torch.float32, [g.cpu() for g in g_gpu], g_cpu)
    phase_s = time.perf_counter() - t_phase
    log(f"  phase union training: {phase_s:.2f} s wall")
    return dict(wall_s=wall_s, phase_s=phase_s, steps=state.step, peak_mib=peak_mb,
                ms_per_step=step_ms, step_peak_mib=step_peak_mb, calls_per_step=per_step,
                profile=profile, host_ops=host, grad_check=grad_check, bits=bits,
                window_losses=[r["loss"] for r in train],
                valid_losses=[r["loss"] for r in valid], launches=launches)


def phase_eval(workdir) -> dict:
    """eval_network's rollout half (eval_rollouts) on the card for the
    checkpoint phase_training leaves, on its one test trajectory: Euler over
    20 steps and the adaptive Tsit5 over 5 save intervals, each held against
    the CPU plain path's rollouts on the same weights (max |Δu| <= 1e-3, the
    serving tolerance) with the same report horizons; steps per second from
    the host clock around a rollout that ends in a device synchronize.
    eval_network whole, its export (trajectories.npz where h5py is missing,
    as on the card) read back: the Euler rollout's bits."""
    from mgn_tpu_torch.api import eval_network, eval_rollouts

    log("phase eval")
    t_phase = time.perf_counter()
    ds, cp = os.path.join(workdir, "ds"), os.path.join(workdir, "cp_train")
    kw = dict(mse_steps=(1, 5, STEPS), num_rollouts=1, mps=MPS, layer_size=LATENT,
              hidden_layers=HIDDEN)
    dt = float(load_dataset(ds, is_training=False).meta["dt"])
    out, preds = {}, {}
    for solver, window in (("euler", {}), ("tsit5_adaptive", {"stop": ADAPTIVE_SAVES * dt})):
        reset_counts()
        reports, exports, name = eval_rollouts(ds, cp, solver=solver, device=DEVICE,
                                               **window, **kw)
        calls = {k: read_counts()[k] for k in FORWARD}
        ref_reports, ref_exports, _ = eval_rollouts(ds, cp, solver=solver, device="cpu",
                                                    **window, **kw)
        pred, ref = exports[0]["prediction"], ref_exports[0]["prediction"]
        preds[solver] = pred
        err = float(np.abs(pred - ref).max())
        r = reports[0]
        log(f"  eval_rollouts({solver!r}): {pred.shape[0] - 1} save steps, "
            f"{r['steps_per_second']:.2f} steps/s ({r['rollout_seconds']:.4f} s, host clock "
            f"to a device synchronize); final_rmse {r['final_rmse']:.6f} (cpu "
            f"{ref_reports[0]['final_rmse']:.6f}); horizons {sorted(r['horizons'])}; cuda vs "
            f"cpu max_abs_err {err:.3e} (tolerance 1e-3); launches {calls}")
        if any(calls[k] <= 0 for k in FORWARD):
            raise AssertionError(f"eval_rollouts({solver!r}) did not run the kernels: {calls}")
        if not (np.isfinite(pred).all() and err <= 1e-3
                and list(r["horizons"]) == list(ref_reports[0]["horizons"])):
            raise AssertionError(f"eval_rollouts({solver!r}) on cuda: max_abs_err {err:.3e}, "
                                 f"horizons {list(r['horizons'])} against "
                                 f"{list(ref_reports[0]['horizons'])}")
        out[solver] = dict(name=name, steps=int(pred.shape[0] - 1),
                           steps_per_second=r["steps_per_second"],
                           rollout_seconds=r["rollout_seconds"], final_rmse=r["final_rmse"],
                           cpu_final_rmse=ref_reports[0]["final_rmse"], max_abs_err=err,
                           horizons=sorted(r["horizons"]), launches=calls)
    elog = MetricsLogger(quiet=True)
    eval_network(ds, cp, os.path.join(workdir, "eval_out"), solver="euler", device=DEVICE,
                 metrics=elog, **kw)
    path = os.path.join(workdir, "eval_out", "euler", export_name())
    if [r["path"] for r in elog.records if r["kind"] == "export"] != [path]:
        raise AssertionError(f"eval_network's export records {elog.records}, expected {path}")
    if not np.array_equal(read_export(path)["prediction"], preds["euler"]):
        raise AssertionError("eval_network's export is not the Euler rollout's bits")
    out["eval_network"] = f"ran whole, exported {os.path.basename(path)}: the rollout's bits"
    log(f"  eval_network: {out['eval_network']}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase eval: {out['phase_s']:.2f} s wall")
    return out


# a cloth forward's kernels: K3 in its node_extra form, K1 on both edge sets
CLOTH_FORWARD = ("edge_project", "edge_round", "node_round_extra", "csr_segment_sum",
                 "csr_segment_sum_perm", "weight_streams")


def phase_eval_cloth(workdir) -> dict:
    """The cloth twin's rollouts (eval_rollouts on the flag's meta) on the
    card, for the checkpoint phase_cloth_training leaves, on its one test
    trajectory: 20 semi-implicit steps, finite, the handles on the data;
    steps per second."""
    from mgn_tpu_torch.api import eval_rollouts

    log("phase eval, cloth")
    t_phase = time.perf_counter()
    ds, cp = os.path.join(workdir, "flag_ds"), os.path.join(workdir, "cp_cloth")
    reset_counts()
    reports, exports, name = eval_rollouts(ds, cp, device=DEVICE, mse_steps=(1, 10),
                                           num_rollouts=1, mps=MPS, layer_size=LATENT,
                                           hidden_layers=HIDDEN)
    counts = read_counts()
    calls = {k: counts[k] for k in CLOTH_FORWARD}
    r, x = reports[0], exports[0]
    handles = load_dataset(ds, is_training=False).trajectory(0).node_type == 3
    log(f"  eval_rollouts on the flag ({name}): {x['prediction'].shape[0] - 2} steps, "
        f"{r['steps_per_second']:.2f} steps/s ({r['rollout_seconds']:.4f} s); final_rmse "
        f"{r['final_rmse']:.6f}; launches {calls}")
    if (name != "semi_implicit" or not np.isfinite(x["prediction"]).all()
            or not np.array_equal(x["prediction"][:, handles], x["gt"][:, handles])
            or not all(calls.values())):
        raise AssertionError(f"cloth eval_rollouts: {name}, launches {calls}")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase eval, cloth: {phase_s:.2f} s wall")
    return dict(name=name, steps_per_second=r["steps_per_second"],
                rollout_seconds=r["rollout_seconds"], final_rmse=r["final_rmse"],
                launches=calls, phase_s=phase_s)


# --- phases 11d, 11e: solver training and the command line ----------------------------

SOLVER = dict(saves=5, steps=5, norm_steps=2, profile_steps=2)  # Euler over 5 save intervals
SHOOTING = dict(saves=2, interval_size=3, adaptive_substeps=4)


class BoundedStats:
    """Records the (accepted, rejected) tries per save interval of each
    odeint_tsit5_bounded call the solver trainer makes while it is entered."""

    def __enter__(self):
        from mgn_tpu_torch.train import solver
        self.calls, self.module = [], solver
        self.inner = solver.odeint_tsit5_bounded

        def record(*args, **kwargs):
            stats = []
            out = self.inner(*args, stats=stats, **kwargs)
            self.calls.append(stats)
            return out

        solver.odeint_tsit5_bounded = record
        return self.calls

    def __exit__(self, *exc):
        self.module.odeint_tsit5_bounded = self.inner


def solver_step_grads(strategy, cfg, spec, params, norm, prep, dev):
    """One solver step (past the warm-up) from a fresh copy of ``params`` on
    ``dev``: its loss and whole-model gradient (the leaves' ``.grad``, left
    by the step)."""
    from mgn_tpu_torch.train.solver import SolverTrainerConfig, make_solver_trainer

    step = make_solver_trainer(SolverTrainerConfig(cfg, spec, strategy, norm_steps=0))
    p = grad_copy(params, dev)
    st = TrainState(p, torch.optim.Adam(param_leaves(p), lr=1e-4), norm.to(dev), 0)
    loss = float(step(st, prep.template, prep.fields, prep.times)[1][0])
    return loss, [q.grad.detach().clone() for q in param_leaves(st.params)]


def phase_solver_training(workdir) -> dict:
    """Solver training at full width on phase_training's 1,900-node dataset
    (random weights from a seed, f32 unless marked): one Euler
    SolverTraining step over 5 save intervals with remat on and off (the
    same bits in loss and gradient; wrapper calls, peak memory), held
    against the CPU plain path; one MultipleShooting step with the bounded
    adaptive Tsit5 (one window of 2 save intervals) against the CPU, the
    same (accepted, rejected) tries per interval on both; train_network
    (SolverTraining) for 5 steps at batchsize 1 and 2; the profiler's
    device busy ms, idle share and device kernels a step with remat on and
    off; one bf16 step against the f32 gradient."""
    from mgn_tpu_torch.api import init_state
    from mgn_tpu_torch.train.solver import SolverTrainerConfig, make_solver_trainer
    from mgn_tpu_torch.train.strategies import MultipleShooting, SolverTraining

    log("phase solver training")
    t_phase = time.perf_counter()
    ds = os.path.join(workdir, "ds")
    model = dict(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN)
    dataset = load_dataset(ds)
    meta = dataset.meta
    dt = float(meta["dt"])
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-4)  # noqa: E731
    state0, cfg, spec = init_state(meta, Args(seed=0, **model), adam, DEVICE)
    nb, eb = common_buckets([dataset.structure(0)], meta, 128, 512)
    prep = prepare_trajectory(dataset.trajectory(0), meta, spec, nb, eb, device=DEVICE)
    prep_cpu = to_cpu_prep(prep)
    out = {}

    # Euler over 5 save intervals, remat on and off, then the CPU
    euler = {r: SolverTraining(0.0, dt, SOLVER["saves"] * dt, solver="euler", remat=r)
             for r in (True, False)}
    runs = {}
    for remat, strategy in euler.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss, grads = solver_step_grads(strategy, cfg, spec, state0.params, state0.norm, prep,
                                        DEVICE)
        torch.cuda.synchronize()
        calls = read_counts()
        runs[remat] = dict(loss=loss, grads=grads, calls=calls,
                           peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                           step_mib=(torch.cuda.max_memory_allocated() - base) / 2 ** 20)
        log(f"  Euler solver step, {SOLVER['saves']} save intervals, remat {remat}: loss "
            f"{loss:.7f}; peak device memory {runs[remat]['peak_mib']:.1f} MiB "
            f"({runs[remat]['step_mib']:.1f} above the step's start); wrapper calls {calls}")
        for name, n in calls.items():
            if n <= 0 and name not in ("node_round_extra", "node_round_bwd_extra") + THREE_PART:
                raise AssertionError(f"the solver step did not launch {name}: {calls}")
        if any(calls[k] for k in THREE_PART):
            raise AssertionError(f"the solver step ran the three-part backward form: {calls}")
        forwards = SOLVER["saves"] * (2 if remat else 1)  # remat runs each forward again
        if calls["edge_round"] != forwards * MPS or calls["edge_round_bwd_defer"] != (
                SOLVER["saves"] * MPS):
            raise AssertionError(f"remat {remat}: K2 {calls['edge_round']} calls, K4 "
                                 f"{calls['edge_round_bwd_defer']}; expected {forwards * MPS}, "
                                 f"{SOLVER['saves'] * MPS}")
    on, off = runs[True], runs[False]
    same = [torch.equal(a, b) for a, b in zip(on["grads"], off["grads"])]
    log(f"  remat on against off: loss {on['loss']!r} / {off['loss']!r}, gradient leaves "
        f"bit for bit {sum(same)} of {len(same)}")
    if on["loss"] != off["loss"] or not all(same):
        raise AssertionError("remat on and off differ on the card")
    loss_c, g_cpu = solver_step_grads(euler[False], cfg, spec, state0.params, state0.norm,
                                      prep_cpu, "cpu")
    log(f"  Euler solver step loss: cuda {on['loss']:.7f}, cpu {loss_c:.7f}")
    out["euler"] = dict(
        loss=on["loss"], cpu_loss=loss_c, remat_bits=sum(same), leaves=len(same),
        peak_mib={"remat": on["peak_mib"], "no_remat": off["peak_mib"]},
        step_mib={"remat": on["step_mib"], "no_remat": off["step_mib"]},
        calls={"remat": on["calls"], "no_remat": off["calls"]},
        grad_check=check_grads("Euler solver-step gradient, cuda vs cpu plain path",
                               torch.float32, [g.cpu() for g in on["grads"]], g_cpu))
    if not abs(on["loss"] - loss_c) <= 1e-4 * abs(loss_c):
        raise AssertionError(f"solver-step loss: cuda {on['loss']}, cpu {loss_c}")

    # MultipleShooting through the bounded adaptive Tsit5, the card against the CPU
    shoot = MultipleShooting(0.0, dt, SHOOTING["saves"] * dt,
                             interval_size=SHOOTING["interval_size"], solver="tsit5_adaptive",
                             adaptive_substeps=SHOOTING["adaptive_substeps"])
    with BoundedStats() as tries:
        reset_counts()
        t0 = time.perf_counter()
        loss_s, g_s = solver_step_grads(shoot, cfg, spec, state0.params, state0.norm, prep,
                                        DEVICE)
        shoot_s = time.perf_counter() - t0
        calls = read_counts()
        # remat gives the same values and gradients; the CPU skips its recompute
        loss_sc, g_sc = solver_step_grads(dataclasses.replace(shoot, remat=False), cfg, spec,
                                          state0.params, state0.norm, prep_cpu, "cpu")
    log(f"  MultipleShooting step (bounded Tsit5, {SHOOTING['saves']} save intervals, budget "
        f"{SHOOTING['adaptive_substeps']}): (accepted, rejected) tries per interval "
        f"{tries[0]} on the card, {tries[1]} on the cpu; loss cuda {loss_s:.7f}, cpu "
        f"{loss_sc:.7f}; {shoot_s:.3f} s on the card; wrapper calls {calls}")
    n_tries = sum(a + r for a, r in tries[0])
    if tries[0] != tries[1]:
        raise AssertionError(f"bounded Tsit5 tries differ: cuda {tries[0]}, cpu {tries[1]}")
    if calls["edge_round"] != 2 * 7 * n_tries * MPS:  # remat: each stage's forward again
        raise AssertionError(f"{calls['edge_round']} K2 calls for {n_tries} tries")
    if not abs(loss_s - loss_sc) <= 1e-4 * abs(loss_sc):
        raise AssertionError(f"shooting loss: cuda {loss_s}, cpu {loss_sc}")
    out["shooting"] = dict(loss=loss_s, cpu_loss=loss_sc, tries=tries[0], cpu_tries=tries[1],
                           seconds=shoot_s, calls=calls,
                           grad_check=check_grads("MultipleShooting gradient, cuda vs cpu",
                                                  torch.float32, [g.cpu() for g in g_s], g_sc))

    # train_network(SolverTraining), batchsize 1 and 2
    out["train_network"] = {}
    for batch in (1, 2):
        metrics = MetricsLogger(quiet=True)
        reset_counts()
        t0 = time.perf_counter()
        state, best = train_network(0.0, adam, ds, os.path.join(workdir, f"cp_solver_{batch}"),
                                    metrics=metrics, device=DEVICE, steps=SOLVER["steps"],
                                    norm_steps=SOLVER["norm_steps"], checkpoint=SOLVER["steps"],
                                    batchsize=batch, solver_valid="euler", seed=0,
                                    training_strategy=euler[True], **model)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        calls = read_counts()
        losses = [r["loss"] for r in metrics.records if r["kind"] == "train"]
        valid = [r["loss"] for r in metrics.records if r["kind"] == "valid"]
        log(f"  train_network(SolverTraining, batchsize={batch}): {state.step} steps "
            f"({SOLVER['norm_steps']} of warm-up) in {wall_s:.2f} s, losses "
            f"{[round(x, 6) for x in losses]}, validation {valid}; wrapper calls {calls}")
        if (state.step != SOLVER["steps"] or len(valid) != 1
                or not np.isfinite(losses + valid).all()
                or any(calls[k] for k in THREE_PART) or not calls["edge_round_bwd_defer"]):
            raise AssertionError(f"train_network(SolverTraining, batchsize={batch}): step "
                                 f"{state.step}, losses {losses}, validation {valid}, "
                                 f"calls {calls}")
        out["train_network"][batch] = dict(wall_s=wall_s, losses=losses, valid=valid,
                                           calls=calls)

    # the step alone: host clock, profiler, remat on and off
    out["profile"] = {}
    for remat, strategy in euler.items():
        step = make_solver_trainer(SolverTrainerConfig(cfg, spec, strategy, norm_steps=0))
        p = grad_copy(state0.params)
        st = TrainState(p, adam(param_leaves(p)), state0.norm, 0)
        run = lambda: float(step(st, prep.template, prep.fields, prep.times)[1][0])  # noqa: E731
        run()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        log(f"  Euler solver step, remat {remat}: {ms:.3f} ms a step (host clock, 3 steps)")
        prof = profile_training(lambda: [run() for _ in range(SOLVER["profile_steps"])],
                                SOLVER["profile_steps"])
        out["profile"]["remat" if remat else "no_remat"] = dict(ms_per_step=ms, **prof)

    # bf16: finite, its gradient against the f32 one
    cfg16, _ = build_model_config(meta, Args(compute_dtype="bfloat16", **model))
    loss16, g16 = solver_step_grads(euler[True], cfg16, spec, state0.params, state0.norm, prep,
                                    DEVICE)
    rel = [float((a.float() - b).norm()) / max(float(b.norm()), 1e-30)
           for a, b in zip(g16, on["grads"])]
    total = float(torch.sqrt(sum((a.float() - b).square().sum() for a, b in zip(g16, on["grads"]))
                             / sum(b.square().sum() for b in on["grads"])))
    log(f"  bf16 Euler solver step: loss {loss16:.7f} (f32 {on['loss']:.7f}); gradient "
        f"relative L2 against f32: whole {total:.4e}, worst leaf {max(rel):.4e}")
    if not (np.isfinite(loss16) and all(torch.isfinite(g).all() for g in g16)):
        raise AssertionError(f"bf16 solver step not finite: loss {loss16}")
    out["bf16"] = dict(loss=loss16, grad_rel_l2=total, worst_leaf_rel_l2=max(rel))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase solver training: {out['phase_s']:.2f} s wall")
    return out


def export_name() -> str:
    """The file eval_network exports to here: trajectories.h5 where h5py
    imports, else trajectories.npz."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "trajectories.npz"
    return "trajectories.h5"


def phase_cli(workdir) -> dict:
    """``python -m mgn_tpu_torch`` on the card, each command a process of its
    own: synth (cylinder, 1,900 nodes, TFRecord), train --strategy shooting
    at full width for 2 steps with a checkpoint, again to 4 (a resume),
    eval, which runs to the end and writes trajectories.npz where h5py is
    missing (the card has none), synth --family plate (the default 4 x 4 x 3
    grid) and convert inspect on it, which must print its train and test
    lines with 48 nodes each; the commands that need nothing of each other
    side by side."""
    log("phase cli")
    t_phase = time.perf_counter()
    ds, cp, out, plate = (os.path.join(workdir, n)
                          for n in ("cli_ds", "cli_cp", "cli_out", "cli_plate"))
    shooting = ["--strategy", "shooting", "--tstop", "0.04", "--interval-size", "3",
                "--checkpoint", "2", "--norm-steps", "1", "--seed", "0"]
    runs = [("synth", ["synth", ds, "--num-nodes", "1900", "--tl", "6", "--n-train", "1",
                       "--n-valid", "1", "--n-test", "1"]),
            ("train 2", ["train", ds, cp, "--steps", "2", *shooting]),
            ("train 4", ["train", ds, cp, "--steps", "4", *shooting]),
            ("eval", ["eval", ds, cp, out, "--solver", "euler", "--num-rollouts", "1"]),
            ("synth plate", ["synth", plate, "--family", "plate", "--tl", "6", "--n-train", "1",
                             "--n-valid", "1", "--n-test", "1"]),
            ("convert inspect", ["convert", "inspect", plate])]
    # the commands in stages, those of a stage side by side (most of a command's time is
    # its process's start-up): each reads only what an earlier stage wrote
    stages = [("synth", "synth plate"), ("train 2", "convert inspect"), ("train 4",), ("eval",)]
    argvs, results = dict(runs), {}
    for stage in stages:
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen([sys.executable, "-m", "mgn_tpu_torch", *argvs[name]],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True) for name in stage}
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            results[name] = (subprocess.CompletedProcess(proc.args, proc.returncode, stdout,
                                                         stderr), time.perf_counter() - t0)
    res = {}
    for name, _ in runs:
        r, secs = results[name]
        res[name] = dict(rc=r.returncode, s=secs)
        records = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
        kinds = [x.get("kind", "inspect") for x in records]
        log(f"  python -m mgn_tpu_torch {name}: exit {r.returncode} in {res[name]['s']:.1f} s; "
            f"records {kinds}; stderr tail {r.stderr.strip().splitlines()[-1:]}")
        if r.returncode != 0:
            raise AssertionError(f"{name}: exit {r.returncode}, stderr {r.stderr[-2000:]}")
        if name == "eval":
            path = os.path.join(out, "euler", export_name())
            export = [x["path"] for x in records if x["kind"] == "export"]
            if export != [path] or not os.path.isfile(path):
                raise AssertionError(f"eval exported {export}, expected {path}")
            res[name]["export"] = os.path.basename(path)
        if name == "convert inspect":
            lines = [x for x in records if "split" in x]
            res[name]["nodes"] = [x["nodes"] for x in lines]
            if [x["split"] for x in lines] != ["train", "test"] or res[name]["nodes"] != [48, 48]:
                raise AssertionError(f"convert inspect printed {r.stdout}")
        if name.startswith("train"):
            train = [x for x in records if x["kind"] == "train"]
            resumed = [x["step"] for x in records if x["kind"] == "resume"]
            res[name].update(losses=[x["loss"] for x in train], resume=resumed)
            if name == "train 4" and (resumed != [2] or [x["step"] for x in train] != [3, 4]):
                raise AssertionError(f"train resume: {resumed}, steps {[x['step'] for x in train]}")
            if not all(np.isfinite(x["loss"]) for x in train):
                raise AssertionError(f"{name}: losses {train}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase cli: {res['phase_s']:.2f} s wall")
    return res


def train_with_default_args(workdir) -> dict:
    """train_network with default Args (the flagship widths; validation by
    the adaptive Tsit5 rollout, solver_valid="tsit5_adaptive") for one short
    window and one validation sweep on a small 1,900-node dataset (one
    6-frame validation trajectory): it raised before its first step until
    the adaptive solver was ported."""
    ds, cp = os.path.join(workdir, "ds_default"), os.path.join(workdir, "cp_default")
    write_synthetic_tfrecord_dataset(ds, num_nodes=1900, tl=6, n_train=1, n_valid=1, n_test=0,
                                     seed=1)
    metrics = MetricsLogger(quiet=True)
    with AdaptiveStats() as calls:
        t0 = time.perf_counter()
        state, best = train_network(0.02, lambda ps: torch.optim.Adam(ps, lr=1e-4), ds, cp,
                                    metrics=metrics, device=DEVICE, steps=10, norm_steps=5,
                                    checkpoint=10)
        wall_s = time.perf_counter() - t0
    valid = [r["loss"] for r in metrics.records if r["kind"] == "valid"]
    log(f"  train_network with default Args (solver_valid={Args().solver_valid!r}): "
        f"{state.step} steps in {wall_s:.2f} s, validation losses {valid}, best {best:.6f}; "
        f"adaptive rollouts: (accepted, rejected) tries per interval "
        f"{[c['tries'] for c in calls]}, {[round(c['seconds'], 3) for c in calls]} s each")
    if not (valid and calls and all(np.isfinite(valid)) and np.isfinite(best)):
        raise AssertionError(f"train_network with default Args: validation {valid}, "
                             f"{len(calls)} adaptive rollouts")
    return dict(steps=state.step, valid_losses=valid, wall_s=wall_s,
                tries_per_interval=[c["tries"] for c in calls],
                rollout_s=[c["seconds"] for c in calls])


# --- phase 8: K3's node_extra form --------------------------------------------------

FLAG = dict(nx=50, ny=32, frames=22, dt=0.02, radius=0.05, per_node=4)


def phase_k3_extra(t_flag, proc):
    """K3 with extra at the flag's node count against its plain version;
    device time, bound, plain time; null and zero extras keep the bits of
    the call without it."""
    log("phase K3 extra")
    gen = torch.Generator(device="cuda").manual_seed(8)
    n_pad, L = t_flag.num_nodes, LATENT
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        nm = F.cast_mlp(proc["node_mlp"], dtype)
        nm0, ws_n = F.round_params(nm, 0), F.weight_streams(nm=nm)[1][0]
        v0 = torch.randn((n_pad, L), generator=gen, device="cuda").to(dtype)
        agg = torch.randn((n_pad, L), generator=gen, device="cuda")
        extra = torch.randn((n_pad, L), generator=gen, device="cuda")
        before = F.node_round.extra_launches
        v_k = v0.clone()
        F.node_round(v_k, agg, nm0, ws_n, extra)
        if F.node_round.extra_launches != before + 1:
            raise AssertionError("K3 with extra was not counted as its extra form")
        v_p = F.node_round_plain(v0, agg, nm0, extra)
        torch.cuda.synchronize()
        err = err_stats(v_k, v_p)
        check_tol("K3 extra one round (v)", dtype, *err)
        if torch.equal(v_k, F.node_round_plain(v0, agg, nm0).to(dtype)):
            raise AssertionError("K3 extra: the offset changed nothing")
        plain_call = v0.clone()
        F.node_round(plain_call, agg, nm0, ws_n)
        for x in (None, torch.zeros_like(extra)):
            again = v0.clone()
            F.node_round(again, agg, nm0, ws_n, x)
            if not torch.equal(again, plain_call):
                raise AssertionError(f"K3 with a {'null' if x is None else 'zero'} extra "
                                     "differs from the call without it")
        v_t = v0.clone()
        ms = device_ms(lambda: F.node_round(v_t, agg, nm0, ws_n, extra), kernels=1)
        no_extra_ms = device_ms(lambda: F.node_round(v_t, agg, nm0, ws_n), kernels=1)
        plain_ms = device_ms(lambda: F.node_round_plain(v0, agg, nm0, extra))
        b = torch.finfo(dtype).bits // 8
        w_n = (2 + HIDDEN) * L * L * b + (HIDDEN + 1) * L * b + 2 * L * 4
        ops = 2 * n_pad * (2 + HIDDEN) * L * L
        nbytes = 2 * n_pad * L * b + 2 * n_pad * L * 4 + w_n  # v in and out, agg, extra
        b_ms, b_by = bound_ms(nbytes, ops, dtype)
        tc_ms, tc_by = bound_ms(nbytes, ops, dtype, PEAK_TC_OPS)
        res[dtype] = dict(max_abs_err=err[0], ms=ms, no_extra_ms=no_extra_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, bound_tc_ms=tc_ms, bound_tc_by=tc_by,
                          library_ms=None, mbytes=nbytes / 1e6)
        log(f"  K3 extra {dtype} (N_pad {n_pad}): device {ms:.5f} ms (without extra "
            f"{no_extra_ms:.5f}), plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}, "
            f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; tensor cores {tc_ms:.5f} ms, "
            f"{tc_by}); null and zero extras give the bits of the call without it")
    return res


# --- phase 9: cloth serving ------------------------------------------------------------

# The card's cloth serving against the CPU's.  f32 by max |dx|: one step
# from the card's own state within 1e-3 standard deviations of the
# acceleration normalizer times dt^2 (the processor's f32 forward tolerance,
# 1e-3 on outputs of order one, in position units); the whole rollout within
# the cylinder's serving bound, 1e-3, up to the first step whose world-edge
# sets differ (a pair at a radius tie: from there the two rollouts take
# different inputs, reported only).  bf16 by relative L2, as the processor's
# bf16 checks: the step's acceleration term (x_{t+1} - 2 x_t + x_{t-1}), and
# the rollout's displacement from its second frame, within 5e-2 (the
# processor's 2e-2 over 15 rounds, plus the encoders', the world set's and
# the decoder's bf16 roundings).  A control, the card's step with the world
# set's term removed, must fail the step check in both dtypes.
# the cloth serving phase's CPU side: each of the first CLOTH_CPU_STEPS steps
# recomputed from the card's state, and the CPU rollout over as many steps (all 20
# before phase_parallel; the f32 rollouts part at a world-edge difference near step 10)
CLOTH_CPU_STEPS = 10
CLOTH_STEP_TOL = {torch.float32: ("max_abs", 1e-3), torch.bfloat16: ("rel_l2", 5e-2)}
CLOTH_ROLLOUT_TOL = {torch.float32: ("max_abs", 1e-3), torch.bfloat16: ("rel_l2", 5e-2)}


def rel_l2(a, b, ref) -> float:
    """||a - b|| / ||ref||."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(ref), 1e-30))


def flag_setup():
    """The 50 x 32 flag, its 22-frame trajectory and Online normalizers
    filled from it (world-edge rows from each frame's radius query)."""
    from mgn_tpu_torch.core.graph import build_world_edges
    from mgn_tpu_torch.data.synthetic import flag_meta, make_flag_mesh, make_flag_trajectory

    pos, cells, nt = make_flag_mesh(FLAG["nx"], FLAG["ny"])
    wp = make_flag_trajectory(pos, nt, tl=FLAG["frames"], dt=FLAG["dt"], seed=0)
    tmpl = build_template(pos, nt, cells=cells)
    capacity = FLAG["per_node"] * tmpl.num_nodes
    n, m = len(pos), tmpl.edge_mask
    s, r = tmpl.senders[m].long(), tmpl.receivers[m].long()
    wpt = torch.from_numpy(wp)
    rel = wpt[:, s] - wpt[:, r]
    mesh = torch.cat([tmpl.mesh_edge_features[m].expand(len(wp), -1, -1), rel,
                      rel.norm(dim=-1, keepdim=True)], -1)
    world, hits = [], []
    pad = torch.zeros((tmpl.num_nodes, 3))
    for frame in wpt:
        pad[:n] = frame
        ws, wr, wm = build_world_edges(pad, tmpl.node_mask, FLAG["radius"], capacity,
                                       tmpl.senders, tmpl.receivers)
        d = pad[ws[wm].long()] - pad[wr[wm].long()]
        world.append(torch.cat([d, d.norm(dim=-1, keepdim=True)], -1))
        hits.append(int(wm.sum()))
    big = 1e7
    norm = NormState(
        edge={"mesh": online_from(mesh.numpy(), big),
              "world": online_from(torch.cat(world).numpy(), big)},
        node={"velocity": online_from(np.diff(wp, axis=0) / FLAG["dt"], big),
              "node_type": N.OfflineMinMax.create(0.0, 1.0)},
        output={"acceleration": online_from(np.diff(wp, 2, axis=0) / FLAG["dt"] ** 2, big)})
    times = (np.arange(FLAG["frames"]) * FLAG["dt"]).astype(np.float32)
    return dict(pos=pos, cells=cells, nt=nt, wp=wp, tmpl=tmpl, capacity=capacity, norm=norm,
                times=times, meta=flag_meta(FLAG["frames"], 1, 1, FLAG["dt"]),
                kept_per_frame=hits)


def world_edge_sets(positions, tmpl, capacity, device) -> list:
    """The world-edge pairs (as flat indices) that the radius query keeps at
    each of ``positions`` (T, N, 3), built on ``device``."""
    from mgn_tpu_torch.core.graph import build_world_edges

    t = tmpl.to(device)
    pad = torch.zeros((t.num_nodes, 3), device=device)
    out = []
    for frame in positions:
        pad[: frame.shape[0]] = torch.as_tensor(frame, device=device)
        ws, wr, wm = build_world_edges(pad, t.node_mask, FLAG["radius"], capacity, t.senders,
                                       t.receivers)
        out.append(set((ws[wm].long() * t.num_nodes + wr[wm].long()).tolist()))
    return out


def cloth_profile(sim, call_args) -> dict:
    """Device time by kernel, the device's idle share and the device
    kernels by name over one simulator call (the profiler's host cost is in
    the wall, so the idle share is an upper bound)."""
    events, wall_ms = profiled(lambda: sim(*call_args))
    groups = dict.fromkeys(("edge_project", "edge_round", "csr_segment_sum", "node_round",
                            "weight_streams", "other"), 0.0)
    kernels, other, k1 = {}, {}, []
    for ev in events:
        us = ev.time_range.elapsed_us()
        if "csr_segment_sum" in ev.name:
            k1.append((ev.time_range.start, us / 1e3))
        key = next((k for k in groups if k != "other" and k in ev.name), "other")
        groups[key] += us / 1e3
        if key == "other":
            other[ev.name[:60]] = other.get(ev.name[:60], 0.0) + us / 1e3
        if not is_copy(ev.name):
            kernels[key] = kernels.get(key, 0) + 1
    busy = sum(groups.values())
    if busy == 0.0:
        raise RuntimeError("the profiler recorded no device activity in the cloth rollout")
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:8])
    # K1's launches in time order alternate: the world set's (in the round's
    # node_extra hook), then the mesh set's
    k1 = [ms for _, ms in sorted(k1)]
    return dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                device_ms=groups, device_kernels=kernels, other_top_ms=top,
                k1_world_ms=sum(k1[0::2]), k1_mesh_ms=sum(k1[1::2]))


def phase_cloth(fs) -> dict:
    """cloth_simulator on the card at flag width, f32 and bf16."""
    from mgn_tpu_torch.models.mgn_multi import init_mgn_multi
    from mgn_tpu_torch.serve import cloth_simulator
    from mgn_tpu_torch.train.cloth import ClothConfig, cloth_model_config

    log("phase cloth serving")
    steps = FLAG["frames"] - 2
    tmpl, wp, times = fs["tmpl"], fs["wp"], fs["times"]
    log(f"  flag {FLAG['nx']} x {FLAG['ny']}: N {len(fs['pos'])} (N_pad {tmpl.num_nodes}), "
        f"{len(fs['cells'])} triangles, E {int(tmpl.edge_mask.sum())} mesh edges (E_pad "
        f"{tmpl.num_edges}), world radius {FLAG['radius']}, {fs['capacity']} world-edge slots; "
        f"slots filled per frame of the trajectory {fs['kept_per_frame']}")
    acc_std = float(fs["norm"].output["acceleration"].std.max())
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = ClothConfig(model=cloth_model_config(fs["meta"], LATENT, HIDDEN, MPS,
                                                   compute_dtype=dtype),
                          world_radius=FLAG["radius"], world_capacity=fs["capacity"])
        params = init_mgn_multi(cfg.model, torch.Generator().manual_seed(0), device="cpu")
        args = (fs["pos"], fs["nt"], fs["cells"], cfg)
        t0 = time.perf_counter()
        sim = cloth_simulator(params, fs["norm"], *args, num_steps=FLAG["frames"])
        build_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        pred = sim(times, wp)
        first_s = time.perf_counter() - t0
        counts = read_counts()
        want = {"edge_project": steps * MPS, "edge_round": steps * MPS, "node_round": 0,
                "node_round_extra": steps * MPS,
                "csr_segment_sum": steps * MPS, "csr_segment_sum_perm": steps * MPS,
                "weight_streams": steps}
        got = {k: counts[k] for k in want}
        log(f"  cloth_simulator {dtype}: {steps} steps in {first_s:.4f} s (first call; built "
            f"in {build_s:.3f} s); launches {got}")
        if got != want:
            raise AssertionError(f"cloth serving {dtype} launched {got}, expected {want}")
        if pred.shape != wp.shape or not np.isfinite(pred).all():
            raise AssertionError(f"cloth_simulator returned shape {pred.shape}, finite "
                                 f"{bool(np.isfinite(pred).all())}")
        handles = fs["nt"] == 3
        if not np.array_equal(pred[:, handles], wp[:, handles]):
            raise AssertionError("cloth serving: handle nodes do not follow the drive")
        if not np.abs(pred[-1] - wp[1]).max() > 1e-3:
            raise AssertionError("cloth serving: the cloth did not move")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            sim(times, wp)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        want_fwd = {"edge_project": MPS, "edge_round": MPS, "node_round": MPS,
                    "csr_segment_sum": 2 * MPS, "weight_streams": 1}
        for attempt in range(3):  # the profiler drops a device event now and then
            prof = cloth_profile(sim, (times, wp))
            per_fwd = {k: v / steps for k, v in prof["device_kernels"].items()}
            if {k: per_fwd.get(k) for k in want_fwd} == want_fwd:
                break
            log(f"  note: profile {attempt + 1} of the cloth rollout counted {per_fwd} device "
                "kernels per forward")
        log(f"  device kernels per forward (profiler): "
            f"{ {k: per_fwd.get(k) for k in want_fwd} } (expected {want_fwd}), other "
            f"{per_fwd.get('other')}")
        if {k: per_fwd.get(k) for k in want_fwd} != want_fwd:
            raise AssertionError(f"cloth forward ran {per_fwd} device kernels, expected "
                                 f"{want_fwd}")
        log(f"  cloth serving {dtype}: median of 3 calls {wall:.4f} s = "
            f"{wall / steps * 1e3:.3f} ms per step (calls {[round(w, 4) for w in walls]}); "
            f"profile: wall {prof['wall_ms']:.3f} ms (profiler on), device busy "
            f"{prof['device_busy_ms']:.3f} ms, idle share {prof['idle_share']:.4f}; by kernel "
            "(ms, share of busy): " + ", ".join(
                f"{k} {v:.3f} ({v / prof['device_busy_ms']:.3f})"
                for k, v in prof["device_ms"].items()))
        log(f"  K1 in the rollout: world set {prof['k1_world_ms']:.3f} ms, mesh set "
            f"{prof['k1_mesh_ms']:.3f} ms per call; largest other device activity (ms per "
            "call): " + ", ".join(f"{k} {v:.3f}" for k, v in prof["other_top_ms"].items()))

        # each step again on the CPU from the card's own state: the same
        # world edges (the radius query gives the same bits on both)
        one = cloth_simulator(params, fs["norm"], *args, device="cpu")
        # the control: the card's step with the world set's term removed
        # (the node MLP's first-layer rows of the world aggregate zeroed, so
        # K3's extra is 0), which the check must refuse
        ctrl_params = copy.deepcopy(params)
        ctrl_params["processor"]["node_mlp"]["w"][0][:, 2 * LATENT:] = 0
        ctrl = cloth_simulator(ctrl_params, fs["norm"], *args)
        step_err, step_rel, ctrl_err, ctrl_rel = [], [], [], []
        for t in range(1, CLOTH_CPU_STEPS + 1):
            frames = np.stack([pred[t - 1], pred[t], wp[t + 1]])
            cpu_next = one(times[t - 1:t + 2], frames)[2]
            ctrl_next = ctrl(times[t - 1:t + 2], frames)[2]
            acc_term = cpu_next - 2 * pred[t] + pred[t - 1]
            step_err.append(float(np.abs(cpu_next - pred[t + 1]).max()))
            step_rel.append(rel_l2(pred[t + 1], cpu_next, acc_term))
            ctrl_err.append(float(np.abs(cpu_next - ctrl_next).max()))
            ctrl_rel.append(rel_l2(ctrl_next, cpu_next, acc_term))
        same_state = world_edge_sets(pred[1:-1], tmpl, fs["capacity"], "cpu")
        same_state_dev = world_edge_sets(pred[1:-1], tmpl, fs["capacity"], "cuda")
        step_mismatch = [len(a ^ b) for a, b in zip(same_state, same_state_dev)]
        kind, tol = CLOTH_STEP_TOL[dtype]
        if kind == "max_abs":
            tol, val, ctrl_val = tol * acc_std * FLAG["dt"] ** 2, max(step_err), max(ctrl_err)
        else:
            val, ctrl_val = max(step_rel), max(ctrl_rel)
        log(f"  one step from the card's state, cpu vs card {dtype}: max |dx| per step "
            f"{[float(f'{e:.3e}') for e in step_err]}, relative L2 of the acceleration term "
            f"{[float(f'{e:.3e}') for e in step_rel]} (tolerance {kind} <= {tol:.3e}; max "
            f"std(acc) {acc_std:.3f}, dt^2 {FLAG['dt'] ** 2:g}); world edges built on the card "
            f"and the cpu from the same state differ by {step_mismatch} pairs per step")
        log(f"  control, the card's step without the world set's term {dtype}: max |dx| per "
            f"step {[float(f'{e:.3e}') for e in ctrl_err]}, relative L2 "
            f"{[float(f'{e:.3e}') for e in ctrl_rel]}; the check reads {kind} {ctrl_val:.3e} "
            f"against its tolerance {tol:.3e} and must refuse it")
        if not ctrl_val > tol:
            raise AssertionError(f"cloth serving {dtype}: the step check passes a step without "
                                 f"the world set's term ({kind} {ctrl_val:.3e} <= {tol:.3e})")
        if not val <= tol or any(step_mismatch):
            raise AssertionError(f"cloth serving {dtype}: a step from the card's state "
                                 f"differs on the cpu by {kind} {val:.3e} (tolerance "
                                 f"{tol:.3e}), world-edge pairs {step_mismatch}")

        # the whole rollout: the same call with device="cpu"
        n_cpu = CLOTH_CPU_STEPS + 2
        ref = cloth_simulator(params, fs["norm"], *args, num_steps=n_cpu,
                              device="cpu")(times[:n_cpu], wp[:n_cpu])
        dx = [float(np.abs(pred[t] - ref[t]).max()) for t in range(n_cpu)]
        rel = [rel_l2(pred[t], ref[t], ref[t] - ref[1]) for t in range(2, n_cpu)]
        mine = world_edge_sets(pred[1:n_cpu - 1], tmpl, fs["capacity"], "cuda")
        theirs = world_edge_sets(ref[1:-1], tmpl, fs["capacity"], "cpu")
        differ = [len(a ^ b) for a, b in zip(mine, theirs)]
        live = [len(x) for x in mine]
        # the first frame whose world edges differ: the frames up to it were
        # computed from the same edges on both
        first = next((i + 1 for i, d in enumerate(differ) if d), None)
        last = first if first else n_cpu - 1
        kind, tol = CLOTH_ROLLOUT_TOL[dtype]
        val = max(dx[: last + 1]) if kind == "max_abs" else max(rel[: last - 1])
        log(f"  whole rollout, cpu vs card {dtype}: max |dx| per frame "
            f"{[float(f'{e:.3e}') for e in dx]}, relative L2 to the displacement from frame 1 "
            f"(frames 2..) {[float(f'{e:.3e}') for e in rel]}; world-edge pairs that differ "
            f"per step {differ}; held to {kind} <= {tol} up to frame {last} (x up to "
            f"{float(np.abs(ref).max()):.3f}); world edges the card kept per step {live} of "
            f"{fs['capacity']} slots (the empty slots sort after every K1 row)")
        if not val <= tol:
            raise AssertionError(f"cloth serving {dtype}: the card's rollout differs from the "
                                 f"cpu's by {kind} {val:.3e} before any world-edge difference")
        res[dtype] = dict(ms_per_step=wall / steps * 1e3, wall_s=wall, first_s=first_s,
                          build_s=build_s, launches=got, device_kernels_per_forward=per_fwd,
                          profile=prof, step_max_abs_dx=step_err, step_rel_l2=step_rel,
                          step_tolerance=CLOTH_STEP_TOL[dtype],
                          step_world_edge_mismatch=step_mismatch,
                          control_step_max_abs_dx=ctrl_err, control_step_rel_l2=ctrl_rel,
                          rollout_max_abs_dx=dx,
                          rollout_rel_l2=rel, rollout_world_edge_differ=differ,
                          rollout_world_edges_kept=live,
                          rollout_tolerance=CLOTH_ROLLOUT_TOL[dtype], rollout_held_to_frame=last)
    res["parts"] = cloth_parts(fs)
    return res


def cloth_parts(fs) -> dict:
    """Device ms per call, at the flag's shapes, of the parts of a cloth
    step that are not K2/K3: K1 on the mesh set (its dead edges all in the
    last row, as the template pads them), K1 through the receiver
    permutation on the world-edge buffer of the trajectory's second frame
    (its empty slots in no row), that permutation, and the radius query."""
    from mgn_tpu_torch.core.graph import build_world_edges
    from mgn_tpu_torch.ops.segment import csr_order

    t = fs["tmpl"].to("cuda")
    pad = torch.zeros((t.num_nodes, 3), device="cuda")
    pad[: len(fs["pos"])] = torch.from_numpy(fs["wp"][1]).to("cuda")
    world = build_world_edges(pad, t.node_mask, FLAG["radius"], fs["capacity"], t.senders,
                              t.receivers)
    gen = torch.Generator(device="cuda").manual_seed(9)
    mesh_msg = torch.randn((t.num_edges, LATENT), generator=gen, device="cuda")
    world_msg = torch.randn((fs["capacity"], LATENT), generator=gen, device="cuda")
    order = csr_order(world[1], t.num_nodes, world[2])
    out = dict(
        k1_mesh_ms=device_ms(lambda: csr_segment_sum(mesh_msg, t.receivers, t.row_offsets,
                                                     t.num_nodes), 200, kernels=1),
        k1_world_ms=device_ms(lambda: csr_segment_sum(world_msg, world[1], order[1],
                                                      t.num_nodes, perm=order[0]), 200,
                              kernels=1),
        world_order_ms=device_ms(lambda: csr_order(world[1], t.num_nodes, world[2]), 200),
        radius_query_ms=device_ms(lambda: build_world_edges(
            pad, t.node_mask, FLAG["radius"], fs["capacity"], t.senders, t.receivers), 20),
        trash_row_edges=int(torch.diff(t.row_offsets)[-1]),
        world_live_edges=int(world[2].sum()),
        world_max_in_degree=int(torch.bincount(world[1][world[2]].long()).max()))
    log("  flag shapes, device ms per call: K1 mesh set {k1_mesh_ms:.5f} (last row "
        "{trash_row_edges} dead edges), K1 world set through the permutation "
        "{k1_world_ms:.5f} ({world_live_edges} live edges, max in-degree "
        "{world_max_in_degree}), the world set's receiver "
        "order (sort, offsets; once a step) {world_order_ms:.5f}, radius query "
        "{radius_query_ms:.4f}".format(**out))
    return out


# --- phase 10: K5's node_extra form ------------------------------------------------------

def k5_inputs(n_pad: int, dtype, gen, proc):
    """One node round's weights (cast, and its row of the node stream with
    K5's adjoint products) and seeded K5 inputs."""
    nm = F.cast_mlp(proc["node_mlp"], dtype)
    ws = F.weight_streams(nm=nm, adjoint=True)[1][0]
    rand = lambda: torch.randn((n_pad, LATENT), generator=gen, device="cuda")
    return dict(nm=F.round_params(nm, 0), ws=ws, v=rand().to(dtype),
                agg=rand().to(dtype), dv=rand().to(dtype), extra=2 * rand())


def k5_bytes(n_pad: int, b: int, extra: bool) -> int:
    """K5's bytes, each input read once and each output written once: v,
    agg and dv in, dv out; the round's weights; the dh and post outputs,
    dagg (f32) and the LayerNorm partial sums; with extra the f32 offset in
    and dxtr (f32) out."""
    return (3 * n_pad * LATENT * b + n_pad * LATENT * b + weight_bytes(2, b)
            + (2 * HIDDEN + 1) * n_pad * LATENT * b + n_pad * LATENT * 4
            + -(-n_pad // F._NODE_BWD_ROWS) * 2 * LATENT * 4
            + (2 * n_pad * LATENT * 4 if extra else 0))


def phase_k5_extra(t_flag, proc):
    """K5 with extra at the flag's node count against
    node_round_bwd_plain(extra=): dv, dagg, dxtr and the parts K6 reads.
    The control (a zero offset: the recompute's ReLU masks are another
    forward's) must fail the same check; a null or zero offset gives the
    bits of K5 without it.  Device time, bound, plain time."""
    log("phase K5 extra")
    gen = torch.Generator(device="cuda").manual_seed(12)
    n_pad, L = t_flag.num_nodes, LATENT
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = k5_inputs(n_pad, dtype, gen, proc)
        nm, ws, v, agg, dv, extra = (x[k] for k in ("nm", "ws", "v", "agg", "dv", "extra"))
        before = F.node_round_bwd.extra_launches
        dv_k = dv.clone()
        dagg, saved, dxtr = F.node_round_bwd(dv_k, v, agg, nm, ws, extra)
        if F.node_round_bwd.extra_launches != before + 1:
            raise AssertionError("K5 with extra was not counted as its extra form")
        ref_dv, ref_dagg, ref_saved, ref_dxtr = F.node_round_bwd_plain(dv, v, agg, nm, extra)
        torch.cuda.synchronize()
        errs = {k: check_bwd(f"K5 extra {k}", dtype, a, b) for k, a, b in (
            ("dv", dv_k, ref_dv), ("dagg", dagg, ref_dagg), ("dxtr", dxtr, ref_dxtr))}
        saved_err = check_saved("K5 extra", dtype, saved, ref_saved)
        if not torch.equal(dxtr, saved.dh[0].float()):
            raise AssertionError("K5 extra: dxtr is not dh0 in f32")
        # the control: a zero offset, the masks of a forward without it
        dz = dv.clone()
        zero = F.node_round_bwd(dz, v, agg, nm, ws, torch.zeros_like(extra))
        control = {}
        for k, a, b in (("dv", dz, ref_dv), ("dxtr", zero[2], ref_dxtr)):
            try:
                check_bwd(f"K5 zero-extra control {k}", dtype, a, b)
            except AssertionError:
                control[k] = float((a.float() - b.float()).norm() / b.float().norm())
            else:
                raise AssertionError(f"K5 extra {dtype}: the check passes a zero extra ({k})")
        # a null offset (the call without it) and a zero one: the same bits
        plain = dv.clone()
        p_dagg, p_saved = F.node_round_bwd(plain, v, agg, nm, ws)
        same = [torch.equal(a, b) for a, b in zip(
            [dz, zero[0], *zero[1].dh, *zero[1].post, zero[1].ln],
            [plain, p_dagg, *p_saved.dh, *p_saved.post, p_saved.ln])]
        if not all(same):
            raise AssertionError(f"K5 with a zero extra differs from K5 without it: {same}")
        ms = device_ms(lambda: F.node_round_bwd(dv.clone(), v, agg, nm, ws, extra),
                       match="node_round_bwd", kernels=1)
        no_extra_ms = device_ms(lambda: F.node_round_bwd(dv.clone(), v, agg, nm, ws),
                                match="node_round_bwd", kernels=1)
        plain_ms = device_ms(lambda: F.node_round_bwd_plain(dv, v, agg, nm, extra))
        b = torch.finfo(dtype).bits // 8
        ops = 2 * 2 * (2 + HIDDEN) * L * L * n_pad  # recompute + adjoint, as FLOP
        nbytes = k5_bytes(n_pad, b, True)
        b_ms, b_by = bound_ms(nbytes, ops, dtype)
        tc_ms, tc_by = bound_ms(nbytes, ops, dtype, PEAK_TC_OPS)
        res[dtype] = dict(max_abs_err=max(e[0] for e in errs.values()),
                          rel_l2={k: e[1] for k, e in errs.items()}, saved_max_abs_err=saved_err,
                          control_rel_l2=control, ms=ms, no_extra_ms=no_extra_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bound_tc_ms=tc_ms,
                          bound_tc_by=tc_by, library_ms=None, gflop=ops / 1e9,
                          mbytes=nbytes / 1e6)
        log(f"  K5 extra {dtype} (N_pad {n_pad}): max_abs_err dv {errs['dv'][0]:.3e}, dagg "
            f"{errs['dagg'][0]:.3e}, dxtr {errs['dxtr'][0]:.3e} (relative L2 "
            f"{[float(f'{e[1]:.3e}') for e in errs.values()]}), K6 parts {saved_err:.3e}; "
            f"control (zero extra) refused, relative L2 {control}; a zero extra gives the bits "
            f"of K5 without it; device {ms:.5f} ms (without extra {no_extra_ms:.5f}), plain "
            f"{plain_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}, {ops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB; tensor cores {tc_ms:.5f} ms, {tc_by})")
    return res


def k5_bits(path: str) -> int:
    """``--k5-bits``: K5 without extra on seeded inputs at the cylinder's and
    the flag's node counts, f32 and bf16 (every output: dv, dagg, dh, post,
    the LayerNorm partial sums); written to ``path``, or held bit for bit
    against it where it exists.  It reads K5's weights from the node stream
    with its adjoint products, so the file comes from a tree whose K5 reads
    that stream: run it twice there (or on two trees with that K5) to see
    that K5 keeps its bits."""
    _build.build_all(["fused_round_bwd"])
    proc = processor(3)
    got = {}
    for label, n_pad in (("cylinder", 1920), ("flag", 1664)):
        for dtype in (torch.float32, torch.bfloat16):
            x = k5_inputs(n_pad, dtype, torch.Generator(device="cuda").manual_seed(13), proc)
            dv = x["dv"].clone()
            dagg, saved = F.node_round_bwd(dv, x["v"], x["agg"], x["nm"], x["ws"])
            for i, t in enumerate([dv, dagg, *saved.dh, *saved.post, saved.ln]):
                got[f"{label} {dtype} {i}"] = t.cpu()
    return hold_bits(got, path, "k5-bits", "K5 without extra")


def hold_bits(got: dict, path: str, mode: str, what: str) -> int:
    """The ``--*-bits`` modes' end: write ``got`` (name -> CPU tensor) to
    ``path``, or, where it exists, hold every output bit for bit against
    it; 0 when written or all identical (the same names), else 1."""
    if not os.path.exists(path):
        torch.save(got, path)
        log(f"{mode}: wrote {len(got)} outputs to {path}")
        return 0
    ref = torch.load(path)
    bits = lambda t: t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)
    same = {k: k in ref and torch.equal(bits(got[k]), bits(ref[k])) for k in got}
    log(f"{mode}: {what} against {path}, bit for bit: "
        f"{sum(same.values())} of {len(same)} outputs identical"
        + ("" if all(same.values()) else f"; differ: {[k for k, v in same.items() if not v]}"))
    return 0 if all(same.values()) and set(got) == set(ref) else 1


def proj_bits(path: str) -> int:
    """``--proj-bits``: K7 and K8 on seeded inputs — at latent 128 at the
    cylinder's, the flag's and the 20k-node mesh's row counts (N_pad 1,920,
    1,664, 20,096), at latents 32, 64 and 256 at the cylinder's, f32 and
    bf16 — written to ``path``, or held bit for bit against it where it
    exists (K7's P and Q, K8's dv).  Then each kernel's device time at the
    cylinder (latent 128, profiler) beside one f32 torch.matmul of the same
    product, as one JSON line.  It uses only names the port has had since
    K8, so copied into a checkout of an earlier commit it records that
    commit's bits and times; run parent, change, change, parent in one call
    to compare both on one card."""
    _build.build_all(["fused_round", "fused_round_bwd"])
    got, times = {}, {}
    cases = [(128, n) for n in (1920, 1664, 20096)] + [(lat, 1920) for lat in (32, 64, 256)]
    for lat, n in cases:
        cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=lat,
                        hidden_layers=HIDDEN, message_passing_steps=1)
        proc = init_mgn(cfg, torch.Generator().manual_seed(3), device="cuda")["processor"]
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(17)
            rand = lambda: torch.randn((n, lat), generator=gen, device="cuda")
            em_all = F.cast_mlp(proc["edge_mlp"], dtype)
            em = F.round_params(em_all, 0)
            ws_p = F.weight_streams(em=em_all, adjoint=True)[2][0]
            size_p = F._stream_sizes(lat, dtype, 0, 0)[2]
            v, g_s, g_r, dv0 = rand().to(dtype), rand(), rand(), rand().to(dtype)
            p, q = F.edge_project(v, em, ws_p[:size_p])
            dv = dv0.clone()
            F.first_layer_adjoint(dv, g_s, g_r, em, ws_p[size_p:])
            key = f"L{lat} N{n} {dtype}"
            got.update({f"{key} P": p.cpu(), f"{key} Q": q.cpu(), f"{key} dv": dv.cpu()})
            if (lat, n) != (LATENT, 1920):
                continue
            k7 = lambda: F.edge_project(v, em, ws_p[:size_p])
            k8 = lambda: F.first_layer_adjoint(dv0.clone(), g_s, g_r, em, ws_p[size_p:])
            times[str(dtype)] = {"edge_project": device_ms(k7, 200, match="edge_project",
                                                           kernels=1),
                                 "first_layer_adjoint": device_ms(k8, 200,
                                                                  match="first_layer_adjoint",
                                                                  kernels=1)}
            if dtype == torch.float32:
                w0 = em["w"][0]
                w7 = torch.cat([w0[lat:2 * lat], w0[2 * lat:]], dim=1).contiguous()
                w8 = torch.cat([w0[k * lat:(k + 1) * lat].t() for k in (1, 2)]).contiguous()
                g_cat = torch.cat([g_s, g_r], dim=1)
                times["library_f32"] = {
                    "edge_project": device_ms(lambda: torch.matmul(v, w7), 200),
                    "first_layer_adjoint": device_ms(lambda: torch.matmul(g_cat, w8), 200)}
    log("proj-time: " + json.dumps(times))
    return hold_bits(got, path, "proj-bits", "K7 and K8")


def k2_plan(n_edges: int, L: int, dtype) -> dict:
    """K2's launch at ``n_edges`` rows: ``ops.fused.edge_plan`` checked
    against the compiled kernel's own numbers (``mgn_edge_round_plan``).  A
    tree from before ``edge_plan`` has neither: there too a 64-edge block
    copied the round's weights for itself, one block a tile."""
    import ctypes

    lib = _build.library("fused_round")
    if not hasattr(F, "edge_plan"):
        kc = min(128 // (torch.finfo(dtype).bits // 8), L)
        stage = (2 * L * kc * 4 if dtype == torch.float32 else L * (kc + 8) * 2)
        blocks = -(-n_edges // 64)
        return dict(col_groups=None, stages=2 if dtype == torch.float32 else 3,
                    grid=blocks, l2_weight_bytes=blocks * (1 + HIDDEN) * (L // kc) * stage)
    plan = F.edge_plan(n_edges, L, dtype, 1 + HIDDEN)
    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.mgn_edge_round_plan(F._DTYPE_CODES[dtype], L, n_edges, out),
                 "edge_round_plan")
    want = [plan[k] for k in ("col_groups", "stages", "threads", "smem", "grid")]
    if list(out) != want:
        raise AssertionError(f"K2's compiled plan {list(out)} is not edge_plan's {want}")
    return plan


def k2_bits(path: str) -> int:
    """``--k2-bits``: K2 on seeded inputs — latent 128 at the cylinder's,
    the flag's and the 20k-node mesh's edges (their templates, dead edges
    included), latents 32, 64 and 256 at the cylinder's, and the cylinder's
    first 1, 63, 64 and 65 edges (the last one dead), f32 and bf16; P and Q
    seeded f32 rows — its msg and updated e written to ``path``, or held bit
    for bit against it where it exists.  It uses only names the port has
    had since K2 took the pre-projected form, so copied into a checkout of
    an earlier commit it records that commit's bits: run there first, then
    here, in one call."""
    from mgn_tpu_torch.data.synthetic import make_flag_mesh

    _build.build_all(["fused_round"])
    *_, cyl = cylinder()
    *_, big = cylinder(20000)
    fpos, fcells, fnt = make_flag_mesh(FLAG["nx"], FLAG["ny"])
    flag = build_template(fpos, fnt, cells=fcells).to("cuda")
    cases = [(128, "cylinder", cyl, None), (128, "flag", flag, None), (128, "20k", big, None)]
    cases += [(lat, "cylinder", cyl, None) for lat in (32, 64, 256)]
    cases += [(128, f"rows{n}", cyl, n) for n in (1, 63, 64, 65)]
    got = {}
    for lat, label, t, rows in cases:
        cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=lat,
                        hidden_layers=HIDDEN, message_passing_steps=1)
        proc = init_mgn(cfg, torch.Generator().manual_seed(3), device="cuda")["processor"]
        n_e = t.num_edges if rows is None else rows
        s, r = t.senders[:n_e].contiguous(), t.receivers[:n_e].contiguous()
        valid = t.edge_mask[:n_e].clone()
        if rows is not None:
            valid[-1] = False
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(29)
            em_all = F.cast_mlp(proc["edge_mlp"], dtype)
            em = F.round_params(em_all, 0)
            ws = F.weight_streams(em_all)[0][0]
            ev = valid.to(dtype)[:, None].contiguous()
            e = (torch.randn((n_e, lat), generator=gen, device="cuda").to(dtype) * ev).contiguous()
            p = torch.randn((t.num_nodes, lat), generator=gen, device="cuda")
            q = torch.randn((t.num_nodes, lat), generator=gen, device="cuda")
            msg = F.edge_round(e, p, q, s, r, ev, em, ws)
            if msg[~valid].any():
                raise AssertionError(f"K2 {label} L{lat} {dtype}: a dead edge produced a message")
            key = f"L{lat} {label} E{n_e} {dtype}"
            got.update({f"{key} msg": msg.cpu(), f"{key} e": e.cpu()})
    return hold_bits(got, path, "k2-bits", "K2's msg and e")


def k2_time() -> int:
    """``--k2-time``: K2's device ms at the cylinder (E_pad 11,264, latent
    128, 2 hidden layers), f32 and bf16, by the profiler's kernel name
    (``edge_round_kernel``, one a call), and the wrapper's ms a call back to
    back (time_ms: the host's rate, since K2 runs faster than it is
    enqueued; 5 batches of 1,000 calls, their median and all five), beside
    the tree's launch shape and the weight bytes a launch copies from L2
    (k2_plan).  It uses only names
    the port has had since K2 took the pre-projected form, so copied into a
    checkout of an earlier commit it times that commit's K2: run parent,
    change, change, parent in one call to compare both on one card.  One
    JSON line, ``k2-time:``."""
    _build.build_all(["fused_round"])
    *_, t = cylinder()
    proc = processor(3)
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        v0, e0, ev = processor_inputs(t, dtype, gen)
        em_all = F.cast_mlp(proc["edge_mlp"], dtype)
        em0 = F.round_params(em_all, 0)
        ws = F.weight_streams(em_all)[0][0]
        p, q = F.edge_project_plain(v0, em0)
        e_t = e0.clone()

        def call():
            F.edge_round(e_t, p, q, t.senders, t.receivers, ev, em0, ws)

        ms = device_ms(call, 200, match="edge_round_kernel", kernels=1)
        host = [time_ms(call, 1000) for _ in range(5)]
        plan = k2_plan(t.num_edges, LATENT, dtype)
        res[str(dtype)] = dict(ms=ms, host_ms=sorted(host)[2], host_ms_runs=host,
                               col_groups=plan["col_groups"], ring_stages=plan["stages"],
                               grid=plan["grid"], l2_weight_mb=plan["l2_weight_bytes"] / 1e6)
    log("k2-time: " + json.dumps(res))
    return 0


def k1_time() -> int:
    """``--k1-time``: K1 and K1-perm alone at the cylinder's template (N_pad
    1,920, E_pad 11,264; trash row 222) and the flag's (N_pad 1,664, E_pad
    10,240; trash row 966), latent 128, f32 and bf16, on seeded data: device
    ms a launch by the profiler's kernel name (``csr_segment_sum_kernel``,
    one a call) over 200 launches each, K1-perm through the template's
    sender permutation; and the world set's K1-perm (``world``: the flag's
    world_order, short rows only, as mgn_multi's world set sums them).  It
    uses only names the port has had since K1-perm, so copied into a
    checkout of an earlier commit it times that commit's K1: run parent,
    change, change, parent in one call to compare both on one card.  One
    JSON line, ``k1-time:``, with the card's name and power limit."""
    from mgn_tpu_torch.data.synthetic import make_flag_mesh
    from mgn_tpu_torch.probes import card

    _build.build_all(["csr_segment"])
    *_, cyl = cylinder()
    pos, cells, nt = make_flag_mesh(FLAG["nx"], FLAG["ny"])
    flag = build_template(pos, nt, cells=cells).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {"card": card()}
    for name, t in (("cylinder", cyl), ("flag", flag)):
        buf = torch.empty((t.num_nodes, LATENT), device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            data = torch.randn((t.num_edges, LATENT), generator=gen, device="cuda").to(dtype)
            k1 = device_ms(lambda: csr_segment_sum(data, t.receivers, t.row_offsets,
                                                   t.num_nodes, out=buf), 200,
                           match="csr_segment_sum_kernel", kernels=1)
            perm = device_ms(lambda: csr_segment_sum(data, t.senders, t.sender_offsets,
                                                     t.num_nodes, perm=t.sender_perm, out=buf),
                             200, match="csr_segment_sum_kernel", kernels=1)
            res[f"{name} {str(dtype)[6:]}"] = {"k1_ms": k1, "perm_ms": perm}
    _, _, perm_w, offsets_w = world_order(flag, gen)
    buf = torch.empty((flag.num_nodes, LATENT), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        data = torch.randn((perm_w.numel(), LATENT), generator=gen, device="cuda").to(dtype)
        res[f"world {str(dtype)[6:]}"] = {"perm_ms": device_ms(
            lambda: csr_segment_sum(data, None, offsets_w, flag.num_nodes, perm=perm_w,
                                    out=buf), 200, match="csr_segment_sum_kernel", kernels=1),
            "rows": int(torch.diff(offsets_w).max()), "live": int(offsets_w[-1])}
    log("k1-time: " + json.dumps(res))
    return 0


def k6_time() -> int:
    """``--k6-time``: K6 alone at the cylinder (E_pad 11,264, N_pad 1,920,
    latent 128, 2 hidden layers) on seeded random operands, f32 and bf16:
    the e part of the edge MLP's first layer with its bias (one product),
    the defer_first form's two N-row products v^T G_s, v^T G_r (G f32;
    bf16: the mixed form), the defer_first edge group and the node group
    (mlp_wgrads).  Each call is held against its plain version (check_bwd;
    the N-row products also within relative L2 1e-5 of the f64 product),
    two calls must give the same bits, and each call's device time is split
    by device kernel name (profiler), beside one f32 torch.matmul of the
    same product and each call's bound.  It uses only names the port has
    had since the defer_first form, so copied into a checkout of an earlier
    commit it times that commit's K6; run parent, change, change, parent in
    one call to compare both on one card.  One JSON line, ``k6-time:``;
    returns the same results."""
    _build.build_all(["wgrad"])
    *_, t = cylinder()
    e_pad, n_pad, L = t.num_edges, t.num_nodes, LATENT
    gen = torch.Generator(device="cuda").manual_seed(23)
    rnd = lambda rows, cols=L: torch.randn((rows, cols), generator=gen, device="cuda")
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        b = torch.finfo(dtype).bits // 8
        e, v, agg = rnd(e_pad).to(dtype), rnd(n_pad).to(dtype), rnd(n_pad).to(dtype)
        g_s, g_r = rnd(n_pad), rnd(n_pad)
        saved = {m: F.MlpSaved([rnd(rows).to(dtype) for _ in range(HIDDEN + 1)],
                               [torch.relu(rnd(rows)).to(dtype) for _ in range(HIDDEN)],
                               rnd(-(-rows // grp), 2 * L))
                 for m, rows, grp in (("edge", e_pad, F._EDGE_BWD_ROWS),
                                      ("node", n_pad, F._NODE_BWD_ROWS))}
        dh0 = saved["edge"].dh[0]
        zeros = lambda *shape: torch.zeros(shape, device="cuda")
        grads = {m: {"w": [zeros(1, parts * L, L)] + [zeros(1, L, L) for _ in range(HIDDEN)],
                     "b": [zeros(1, L) for _ in range(HIDDEN + 1)],
                     "ln_scale": zeros(1, L), "ln_bias": zeros(1, L)}
                 for m, parts in (("edge", 3), ("node", 2))}
        dw, db, dw_rows = zeros(L, L), zeros(L), zeros(2 * L, L)
        rows_group = [F.WgradProduct(g_s, [(v, None)], dw_rows[:L]),
                      F.WgradProduct(g_r, [(v, None)], dw_rows[L:])]
        edge_in, node_in = [(e, None)], [(v, None), (agg, None)]
        deferred = [(v, g_s), (v, g_r)]
        flat = lambda m: ([g[0] for g in grads[m]["w"]] + [g[0] for g in grads[m]["b"]]
                          + [torch.cat([grads[m]["ln_scale"][0], grads[m]["ln_bias"][0]])])
        calls = {
            "e_part": (lambda: F.wgrad(dh0, e, None, dw=dw, db=db), lambda: [dw, db],
                       lambda: list(F.wgrad_plain(dh0, e))),
            "node_rows": (lambda: F.wgrad_group(rows_group), lambda: [dw_rows],
                          lambda: [torch.cat([F.wgrad_plain(g, v)[0] for g in (g_s, g_r)])]),
            "edge_defer": (lambda: F.mlp_wgrads(saved["edge"], edge_in, grads["edge"], 0,
                                                deferred=deferred),
                           lambda: flat("edge"),
                           lambda: wgrad_library(saved["edge"], edge_in, deferred)),
            "node": (lambda: F.mlp_wgrads(saved["node"], node_in, grads["node"], 0),
                     lambda: flat("node"),
                     lambda: wgrad_library(saved["node"], node_in)),
        }
        r = {}
        for name, (fn, outputs, plain) in calls.items():
            fn()
            first = [o.clone() for o in outputs()]
            fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, o) for a, o in zip(first, outputs())):
                raise AssertionError(f"K6 {name} {dtype}: two calls gave different bits")
            err = max(check_bwd(f"K6 {name} [{i}]", torch.float32, a, ref)[0]
                      for i, (a, ref) in enumerate(zip(first, plain())))
            split = device_split(fn, 200, match="wgrad")
            r[name] = dict(ms=sum(split.values()), kernels=split, max_abs_err=err)
        exact = torch.cat([v.double().t() @ g.double() for g in (g_s, g_r)])
        r["node_rows"]["rel_l2_f64"] = float((dw_rows.double() - exact).norm() / exact.norm())
        if not r["node_rows"]["rel_l2_f64"] <= 1e-5:
            raise AssertionError(f"K6 N-row products {dtype}: relative L2 "
                                 f"{r['node_rows']['rel_l2_f64']:.3e} from the f64 product")
        counters = getattr(F, "_wgrad_counters", None)
        if counters is not None and bool(counters(torch.cuda.current_device()).any()):
            raise AssertionError(f"K6 {dtype}: a tile counter is not back at 0")
        r["e_part"]["bound_ms"], r["e_part"]["bound_by"] = bound_ms(
            2 * e_pad * L * b + (L * L + L) * 4, 2 * e_pad * L * L + e_pad * L, dtype,
            PEAK_TC_OPS)
        r["node_rows"]["bound_ms"], r["node_rows"]["bound_by"] = bound_ms(
            n_pad * L * b + 2 * n_pad * L * 4 + 2 * L * L * 4, 2 * 2 * n_pad * L * L,
            torch.float32, PEAK_TC_OPS)
        # the groups: every dh, ReLU output and first-layer input read once (the
        # LayerNorm partial sums and G f32), every gradient written once
        out_bytes = lambda parts: ((parts + HIDDEN) * L * L + (HIDDEN + 3) * L) * 4
        for name, rows, n_x, n_g, ln, parts in (
                ("edge_defer", e_pad, 1, 2, saved["edge"].ln, 3),
                ("node", n_pad, 2, 0, saved["node"].ln, 2)):
            nbytes = ((2 * HIDDEN + 1) * rows * L * b + n_x * rows * L * b
                      + (n_pad * L * b + n_g * n_pad * L * 4 if n_g else 0)
                      + ln.numel() * 4 + out_bytes(parts))
            ops = 2 * rows * (n_x + HIDDEN) * L * L + 2 * n_g * n_pad * L * L
            r[name]["bound_ms"], r[name]["bound_by"] = bound_ms(nbytes, ops, dtype,
                                                                PEAK_TC_OPS)
            r[name]["mbytes"] = nbytes / 1e6
        if dtype == torch.float32:
            g_cat = torch.cat([g_s, g_r], dim=1)
            r["e_part"]["library_ms"] = device_ms(lambda: torch.matmul(e.t(), dh0), 200)
            r["node_rows"]["library_ms"] = device_ms(lambda: torch.matmul(v.t(), g_cat), 200)
            r["edge_defer"]["library_ms"] = device_ms(
                lambda: wgrad_library(saved["edge"], edge_in, deferred), 50)
            r["node"]["library_ms"] = device_ms(lambda: wgrad_library(saved["node"], node_in),
                                                50)
        res[str(dtype)] = r
    log("k6-time: " + json.dumps(res))
    return res


# --- phase 11: cloth training ------------------------------------------------------------

# 20 optimizer-path steps on one 22-frame flag trajectory (frames 1..20, one
# window), the first 5 of them warm-up; one validation sweep at the end
CLOTH_TRAIN = dict(steps=20, norm_steps=5, checkpoint=20, noise=0.003)
CLOTH_KERNELS = ("edge_project", "edge_round", "csr_segment_sum", "csr_segment_sum_perm",
                 "node_round_extra", "weight_streams", "edge_round_bwd_defer",
                 "node_round_bwd_extra", "wgrad", "first_layer_adjoint")


def cloth_frame_grads(params, norm, tm, wp, times, t: int, cfg, world_edges):
    """One frame's loss and whole-model gradient, noise 0, normalizers as
    given (no accumulation), on the given world edges: the cloth trainer's
    loss on the cloth trainer's inputs."""
    from mgn_tpu_torch.models.mgn_multi import apply_mgn_multi
    from mgn_tpu_torch.train.cloth import build_cloth_graph

    with torch.no_grad():
        dt = times[t] - times[t - 1]
        cur = wp[t]
        vel = (cur - wp[t - 1]) / dt
        target = norm.output["acceleration"]((wp[t + 1] - 2 * cur + wp[t - 1]) / (dt * dt))
        graph = build_cloth_graph(norm, tm, cur, vel, cfg, world_edges)
    update = type_mask(tm.node_type, cfg.types_updated) & tm.node_mask
    loss = masked_mse(apply_mgn_multi(params, graph, cfg.model), target, update)
    return loss, torch.autograd.grad(loss, param_leaves(params))


def world_leaf_mask(params) -> list:
    """Per leaf of ``param_leaves(params)``: whether the world set alone
    feeds it (its encoder and its edge MLP)."""
    world = {id(t) for t in param_leaves([params["edge_encoders"][1],
                                          params["processor"]["edge_mlps"][1]])}
    return [id(t) in world for t in param_leaves(params)]


def phase_cloth_training(workdir, fs):
    """mgn_tpu_torch.train_network on a TFRecord flag dataset at full width,
    then its step on one trajectory: ms per step, device busy and idle
    share, kernels per step by the profiler, peak memory; one frame's
    whole-model gradient and three noise-free steps against the CPU."""
    from mgn_tpu_torch.api_cloth import init_cloth_state
    from mgn_tpu_torch.data.synthetic import write_flag_tfrecord_dataset
    from mgn_tpu_torch.train.cloth import make_cloth_trainer

    log("phase cloth training")
    ds, cp = os.path.join(workdir, "flag_ds"), os.path.join(workdir, "cp_cloth")
    t0 = time.perf_counter()
    write_flag_tfrecord_dataset(ds, nx=FLAG["nx"], ny=FLAG["ny"], tl=FLAG["frames"], n_train=1,
                                n_valid=1, n_test=1, dt=FLAG["dt"], seed=0)
    log(f"  wrote a {FLAG['nx']} x {FLAG['ny']} flag TFRecord dataset (1 train + 1 valid + 1 "
        f"test trajectory of {FLAG['frames']} frames) in {time.perf_counter() - t0:.2f} s")
    model = dict(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN)
    metrics = MetricsLogger(quiet=True)
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-4)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, best = train_network(CLOTH_TRAIN["noise"], adam, ds, cp, metrics=metrics,
                                device=DEVICE, steps=CLOTH_TRAIN["steps"],
                                norm_steps=CLOTH_TRAIN["norm_steps"],
                                checkpoint=CLOTH_TRAIN["checkpoint"], seed=0, **model)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    train = [r for r in metrics.records if r["kind"] == "train"]
    valid = [r for r in metrics.records if r["kind"] == "valid"]
    log(f"  train_network (cloth): {state.step} steps ({CLOTH_TRAIN['norm_steps']} of warm-up), "
        f"{len(valid)} validation sweep, {wall_s:.2f} s in all; window losses "
        f"{[round(r['loss'], 6) for r in train]}, validation losses "
        f"{[round(r['loss'], 6) for r in valid]}; peak device memory {peak_mb:.1f} MiB")
    log(f"  launches in train_network (cloth): {launches}")
    missing = [k for k in CLOTH_KERNELS if launches[k] <= 0]
    if missing or launches["node_round"] or launches["node_round_bwd"] or any(
            launches[k] for k in THREE_PART):
        raise AssertionError(f"cloth training did not run through {missing}, or ran K3/K5 "
                             f"without their extra forms or K4's three-part form: {launches}")
    if state.step != CLOTH_TRAIN["steps"] or len(valid) != 1 or not all(
            np.isfinite(r["loss"]) for r in train + valid):
        raise AssertionError(f"cloth training did not run as set up: step {state.step}, "
                             f"{len(valid)} validation sweeps, losses {train + valid}")

    # the step on one prepared trajectory, past the warm-up
    dataset = load_dataset(ds)
    meta = dataset.meta
    nb, eb = common_buckets([dataset.structure(0)], meta, 128, 512)
    _, cfg, spec = init_cloth_state(meta, Args(norm_steps=0, **model), adam,
                                    CLOTH_TRAIN["noise"], nb, DEVICE)
    prep = prepare_trajectory(dataset.trajectory(0), meta, spec, nb, eb, device=DEVICE)
    tm, wp, times = prep.template, prep.fields["world_pos"], prep.times
    log(f"  flag: N {prep.num_nodes} (N_pad {tm.num_nodes}), E_pad {tm.num_edges}, "
        f"{cfg.world_capacity} world-edge slots, latent {LATENT}, {HIDDEN} hidden layers, "
        f"{MPS} rounds, f32")
    trainer = make_cloth_trainer(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    perm = list(range(1, FLAG["frames"] - 1))
    trainer(state, tm, wp, times, perm[:2], gen)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer(state, tm, wp, times, perm, gen)  # returns host losses
    step_ms = (time.perf_counter() - t0) * 1e3 / len(perm)
    per_step = {k: v / len(perm) for k, v in read_counts().items()}
    step_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    residual_mb = MPS * (2 * tm.num_nodes + tm.num_edges) * LATENT * 4 / 1e6
    log(f"  cloth training step (forward + backward + Adam, noise {CLOTH_TRAIN['noise']}): "
        f"{step_ms:.3f} ms per step over {len(perm)} steps; peak device memory "
        f"{step_peak_mb:.1f} MiB; mesh residual stacks {residual_mb:.1f} MB per step; wrapper "
        f"calls per step {per_step}")
    profile = profile_training(lambda: trainer(state, tm, wp, times, perm[:5], gen), 5)
    want = {"weight_streams": MPS, "edge_project": 2 * MPS, "edge_round": MPS, "node_round": MPS,
            "edge_round_bwd": MPS, "node_round_bwd": MPS, "wgrad": 2 * MPS,
            "csr_segment_sum": 6 * MPS, "first_layer_adjoint": MPS}
    seen = {k: round(v) for k, v in (profile.get("device_kernels_per_step") or {}).items()}
    log(f"  device kernels per step (profiler): {seen}, expected {want} (K3 and K5 all in their "
        f"extra forms; csr_segment_sum is K1 and K1-perm, one kernel: by the wrappers' counters "
        f"K1 {per_step['csr_segment_sum']:g} + K1-perm {per_step['csr_segment_sum_perm']:g})")
    if seen != want:
        raise AssertionError(f"cloth training ran {seen} device kernels per step, expected {want}")

    # one frame's whole-model gradient: the card against the CPU plain path,
    # on world edges built once (on the CPU) and given to both
    from mgn_tpu_torch.train.cloth import cloth_world_edges

    frame = 7
    tm_c, wp_c, times_c = tm.to("cpu"), wp.cpu(), times.cpu()
    we_cpu = cloth_world_edges(tm_c, wp_c[frame], cfg)
    we_dev = cloth_world_edges(tm, wp[frame], cfg)
    agree = all(torch.equal(a.cpu(), b) for a, b in zip(we_dev, we_cpu))
    we = tuple(x.to(DEVICE) for x in we_cpu)
    grads_dev = []
    for _ in range(2):
        loss_g, g = cloth_frame_grads(grad_copy(state.params), state.norm, tm, wp, times, frame,
                                      cfg, we)
        grads_dev.append(g)
    identical = all(torch.equal(a, b) for a, b in zip(*grads_dev))
    loss_c, g_cpu = cloth_frame_grads(grad_copy(state.params, "cpu"), state.norm.to("cpu"), tm_c,
                                      wp_c, times_c, frame, cfg, we_cpu)
    log(f"  frame {frame}: world edges built on the card and the cpu agree: {agree} "
        f"({int(we_cpu[2].sum())} live of {cfg.world_capacity}); loss {DEVICE} "
        f"{float(loss_g.detach()):.7f}, cpu {float(loss_c.detach()):.7f}; two backward passes "
        f"on the card give the same bits: {identical}")
    if not identical:
        raise AssertionError("cloth gradient: two backward passes on the card differ")
    grad_check = check_grads("cloth whole-model gradient, cuda vs cpu plain path",
                             torch.float32, [g.cpu() for g in grads_dev[0]], g_cpu)
    is_world = world_leaf_mask(state.params)
    w_got = [g.cpu() for g, w in zip(grads_dev[0], is_world) if w]
    w_ref = [g for g, w in zip(g_cpu, is_world) if w]
    grad_check["world"] = check_grads("  of which the world set's leaves", torch.float32, w_got,
                                      w_ref)
    if not all(float(g.abs().max()) > 0 for g in w_got):
        raise AssertionError("cloth gradient: a world-set leaf has no gradient")

    # three noise-free steps from the same state on both devices
    import dataclasses

    steps, frames = [], [1, 7, 14]
    cfg0 = dataclasses.replace(cfg, noise_stddev=0.0, norm_steps=0)
    for dev, tm_d, wp_d, times_d in ((DEVICE, tm, wp, times), ("cpu", tm_c, wp_c, times_c)):
        p = grad_copy(state.params, dev)
        st = TrainState(p, adam(param_leaves(p)), state.norm.to(dev), 0)
        _, losses = make_cloth_trainer(cfg0)(st, tm_d, wp_d, times_d, frames,
                                             torch.Generator(device=dev).manual_seed(0))
        steps.append(losses.numpy())
    differ = [len(a ^ b) for a, b in zip(
        world_edge_sets(wp_c[frames, : prep.num_nodes].numpy(), fs["tmpl"], cfg.world_capacity,
                        "cuda"),
        world_edge_sets(wp_c[frames, : prep.num_nodes].numpy(), fs["tmpl"], cfg.world_capacity,
                        "cpu"))]
    rel = float(np.max(np.abs(steps[0] - steps[1]) / np.abs(steps[1])))
    log(f"  3 noise-free steps (frames {frames}): cuda losses {steps[0].tolist()}, cpu "
        f"{steps[1].tolist()}, max relative difference {rel:.3e} (tolerance 1e-3); world-edge "
        f"pairs that differ between the card's and the cpu's query per frame {differ}")
    if not rel <= 1e-3:
        raise AssertionError(f"cloth training steps on cuda differ from the cpu by {rel:.3e}")
    return launches, per_step, dict(
        wall_s=wall_s, steps=CLOTH_TRAIN["steps"], peak_mib=peak_mb, ms_per_step=step_ms,
        step_peak_mib=step_peak_mb, residual_mb=residual_mb, profile=profile,
        device_kernels_per_step=seen, grad_check=grad_check, world_edges_agree=agree,
        backward_bits_identical=identical, step_losses_rel_diff=rel,
        step_world_edge_differ=differ, window_losses=[r["loss"] for r in train],
        valid_losses=[r["loss"] for r in valid])


def k3_bits(path: str) -> int:
    """``--k3-bits``: K3 without extra, 15 rounds on seeded inputs at the
    cylinder's and the flag's node counts, f32 and bf16; written to
    ``path``, or held bit for bit against it where it exists."""
    _build.build_all(["fused_round"])
    proc = processor(3)
    got = {}
    for label, n_pad in (("cylinder", 1920), ("flag", 1664)):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(11)
            nm = F.cast_mlp(proc["node_mlp"], dtype)
            ws_n = F.weight_streams(nm=nm)[1]
            v = torch.randn((n_pad, LATENT), generator=gen, device="cuda").to(dtype)
            agg = torch.randn((n_pad, LATENT), generator=gen, device="cuda")
            for r in range(MPS):
                F.node_round(v, agg, F.round_params(nm, r), ws_n[r])
            got[f"{label} {dtype}"] = v.cpu()
    return hold_bits(got, path, "k3-bits", "K3 without extra")


# --- phase 6: serving ----------------------------------------------------------

def online_from(x: np.ndarray, max_acc: float) -> N.Online:
    """Online accumulators filled from data rows, as training leaves them."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return N.Online(acc_count=f(1.0), num_accumulations=f(len(x)), acc_sum=f(x.sum(0)),
                    acc_sum_sq=f((x * x).sum(0)), max_acc=f(max_acc), std_epsilon=f(1e-8))


def serving_call(workdir, layer_size: int = LATENT, steps: int = STEPS) -> dict:
    """simulate's arguments at full width (or ``layer_size``): a checkpoint
    of random weights from a seed, with Online normalizers filled from a
    synthetic trajectory of the 1,900-node channel mesh, written under
    ``workdir``; one initial frame and 20 (``steps``) Euler steps."""
    dt = 0.01
    meta = synthetic_meta(tl=steps + 1, n_train=1, n_valid=1, dt=dt)
    with open(os.path.join(workdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    pos, cells, nt = make_channel_mesh(1900, seed=0)
    vel = make_trajectory(pos, nt, tl=steps + 1, dt=dt, seed=1)
    args = Args(mps=MPS, layer_size=layer_size, hidden_layers=HIDDEN)
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
    times = (np.arange(steps + 1) * dt).astype(np.float32)
    return dict(meta_dir=workdir, cp_path=cp, mesh_pos=pos, node_type=nt,
                initial_fields={"velocity": vel[0]}, times=times, cells=cells,
                mps=MPS, layer_size=layer_size, hidden_layers=HIDDEN)


def phase_serving(workdir):
    log("phase serving")
    call = serving_call(workdir)
    pos = call["mesh_pos"]
    tmpl = build_template(pos, call["node_type"], cells=call["cells"])
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
        want = STEPS if name == "weight_streams" else STEPS * MPS  # once per forward
        if n < want:
            raise AssertionError(f"{name} launched {n} times, expected >= {want}")
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
                          edge_updates_per_s=e_real * MPS * STEPS / wall, profile=profile), call


ADAPTIVE_SAVES = 3  # save intervals of the adaptive serving check (5 before phase_parallel)


class AdaptiveStats:
    """Records each odeint_tsit5_adaptive call that make_rollout_fn makes
    (the sharded rollouts' too) while it is entered: per call its
    (accepted, rejected) tries per save interval and its host-clock seconds
    (the call ends in a host sync)."""

    def __init__(self):
        from mgn_tpu_torch.rollout import evaluate
        self.module = evaluate

    def __enter__(self):
        self.calls, self.inner = [], self.module.odeint_tsit5_adaptive
        module = self.module

        def record(*args, **kwargs):
            stats, t0 = [], time.perf_counter()
            kwargs.pop("stats", None)
            out = self.inner(*args, stats=stats, **kwargs)
            self.calls.append(dict(tries=stats, seconds=time.perf_counter() - t0))
            return out

        module.odeint_tsit5_adaptive = record
        return self.calls

    def __exit__(self, *exc):
        self.module.odeint_tsit5_adaptive = self.inner


def phase_adaptive(call):
    """simulate(solver="tsit5_adaptive") at the cylinder's width over a few
    save points, on the card and on the CPU plain path: tries per interval,
    ms per interval, and the two rollouts within 1e-3 (the Euler check's
    tolerance; each device takes its own accept decisions, within rtol
    1e-4, atol 1e-6)."""
    log("phase serving, adaptive Tsit5")
    call = dict(call, times=call["times"][:ADAPTIVE_SAVES + 1], solver="tsit5_adaptive")
    with AdaptiveStats() as calls:
        reset_counts()
        t0 = time.perf_counter()
        pred = simulate(**call)
        wall = time.perf_counter() - t0
        launches = {name: read_counts()[name] for name in FORWARD}
        ref = simulate(**call, device="cpu")
    dev_tries, cpu_tries = calls[0]["tries"], calls[1]["tries"]
    err = float(np.abs(pred - ref).max())
    tries = sum(a + r for a, r in dev_tries)
    ms_interval = calls[0]["seconds"] * 1e3 / ADAPTIVE_SAVES
    log(f"  simulate(solver='tsit5_adaptive'), {ADAPTIVE_SAVES} save intervals: (accepted, "
        f"rejected) tries per interval {dev_tries} on the card, {cpu_tries} on the cpu; "
        f"{ms_interval:.3f} ms per interval ({calls[0]['seconds'] * 1e3 / tries:.3f} ms per "
        f"try, one host sync and 7 forwards each; {wall:.3f} s the whole call); launches "
        f"{launches}; cuda vs cpu max_abs_err {err:.3e} (tolerance 1e-3)")
    if pred.shape != (ADAPTIVE_SAVES + 1, len(call["mesh_pos"]), 2) or not np.isfinite(
            pred).all():
        raise AssertionError(f"adaptive simulate returned shape {pred.shape}")
    if launches["edge_round"] != 7 * tries * MPS:
        raise AssertionError(f"adaptive simulate: {launches['edge_round']} K2 launches for "
                             f"{tries} tries of 7 forwards")
    if not err <= 1e-3:
        raise AssertionError(f"adaptive simulate on cuda differs from the cpu by {err:.3e}")
    return dict(tries_per_interval=dev_tries, cpu_tries_per_interval=cpu_tries,
                ms_per_interval=ms_interval, ms_per_try=calls[0]["seconds"] * 1e3 / tries,
                max_abs_err=err, launches=launches)


def profile_serving(call) -> dict:
    """Device time by kernel and the device's idle share over one simulate
    call, from torch.profiler's CUDA activity (the profiler's own host cost
    is in the wall time, so the idle share is an upper bound)."""
    events, wall_ms = profiled(lambda: simulate(**call))
    groups = {"edge_project": 0.0, "edge_round": 0.0, "csr_segment_sum": 0.0,
              "node_round": 0.0, "weight_streams": 0.0, "other": 0.0}
    for ev in events:
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



EXPORT_STEPS = 10  # Euler steps of the export phase's card artefact
EXPORT_SHORT = 5  # steps of the export phase's CPU-to-card and bf16 artefacts
HOST_TIME = dict(serve_calls=5, train_calls=3)

# the fresh process that runs a card artefact: it imports load_simulator
# (mgn_tpu_torch.serve, the operator library) and, for the profile, the
# port's guarded profiler, and nothing of api, models or data
EXPORT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
from mgn_tpu_torch.serve import load_simulator
import_s = time.perf_counter() - t0
import numpy as np
import torch
from mgn_tpu_torch.ops import csr_segment as C, fused as F
from mgn_tpu_torch.utils.profiling import guarded_profile

blob_path, inputs_path, ref_path, out_path = sys.argv[1:5]
counters = {"weight_streams": F.weight_streams, "edge_project": F.edge_project,
            "edge_round": F.edge_round, "csr_segment_sum": C.csr_segment_sum,
            "node_round": F.node_round}
t0 = time.perf_counter()
with open(blob_path, "rb") as fh:
    sim = load_simulator(fh.read(), device="cuda")
load_s = time.perf_counter() - t0
inputs = np.load(inputs_path)
args = (inputs["times"], inputs["v0"])
for fn in counters.values():
    fn.launches = 0
t0 = time.perf_counter()
pred = sim(*args)
first_s = time.perf_counter() - t0
launches = {k: fn.launches for k, fn in counters.items()}
same = bool(np.array_equal(pred, np.load(ref_path)))
walls = []
for _ in range(5):
    t0 = time.perf_counter()
    sim(*args)
    walls.append(time.perf_counter() - t0)
kernels, busy_ms, wall_ms = {}, None, None
for _ in range(3):
    with guarded_profile() as g:
        sim(*args)
    if g.events and g.intact:
        busy_ms, wall_ms = sum(ev.time_range.elapsed_us() for ev in g.events) / 1e3, g.wall_ms
        for ev in g.events:
            if not ev.name.startswith(("Memcpy", "Memset")):
                kernels[ev.name] = kernels.get(ev.name, 0) + 1
        break
banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mgn_tpu")
                or m.startswith(("mgn_tpu_torch.api", "mgn_tpu_torch.models",
                                 "mgn_tpu_torch.data")))
with open(out_path, "w") as fh:
    json.dump(dict(import_s=import_s, load_s=load_s, first_s=first_s, walls_s=walls,
                   launches=launches, same_bits=same, device_busy_ms=busy_ms,
                   profile_wall_ms=wall_ms, device_kernels=kernels, banned_modules=banned,
                   shape=list(pred.shape)), fh)
"""


def graph_census(blob: bytes) -> dict:
    """What an artefact's exported graph calls: each serving operator, the
    copies (aten clone) and any functionalising wrapper (auto_functionalized)
    a mutating operator might have been put in, and the graph's size."""
    import io

    program = torch.export.load(io.BytesIO(blob))
    calls = {}
    for node in program.graph.nodes:
        if node.op == "call_function":
            calls[str(node.target)] = calls.get(str(node.target), 0) + 1
    return dict(operators={k.split(".")[1]: v for k, v in calls.items()
                           if k.startswith("mgn_tpu_torch.")},
                clone=sum(v for k, v in calls.items() if "clone" in k),
                auto_functionalized=sum(v for k, v in calls.items() if "auto_functionalized" in k),
                nodes=len(program.graph.nodes), calls=sum(calls.values()))


def same_bits(label: str, got: np.ndarray, ref: np.ndarray) -> None:
    same = bool(got.shape == ref.shape and np.array_equal(got, ref))
    log(f"  {label}: {'the same bits' if same else 'DIFFERENT'} (shape {tuple(got.shape)}, "
        f"max |diff| {float(np.abs(got - ref).max()) if got.shape == ref.shape else 'n/a'})")
    if not same:
        raise AssertionError(f"{label}: the artefact's result differs from the eager route's")


def phase_export(workdir, call, fs, flag_job) -> dict:
    """The serving artefacts (mgn_tpu_torch.serve) on the card: the cylinder
    at full width (the serving call's first EXPORT_STEPS Euler steps)
    exported here and run in a fresh process (simulate's bits,
    the kernels' launches by the counters and the profiler), an artefact
    exported on the CPU and moved to the card, the bf16 artefact, and the
    flag's cloth artefact (``flag_job``: the process that has exported it
    since the run's start), each against its eager route bit for bit."""
    from mgn_tpu_torch.serve import cloth_simulator, export_simulator, load_simulator

    log("phase export")
    call = dict(call, times=call["times"][:EXPORT_STEPS + 1])  # the serving call's first steps
    times, v0 = call["times"], call["initial_fields"]["velocity"]
    export_call = {k: v for k, v in call.items() if k not in ("initial_fields", "times")}
    steps, res = len(times) - 1, {}
    want = dict(weight_streams=steps, edge_project=steps * MPS, edge_round=steps * MPS,
                csr_segment_sum=steps * MPS, node_round=steps * MPS)

    def exported(label, fn, census=False, **kwargs):
        t0 = time.perf_counter()
        blob = fn(**kwargs)
        secs = time.perf_counter() - t0
        res[label] = dict(export_s=secs, bytes=len(blob))
        if census:  # a deserialization of its own, as long as a load
            res[label]["graph"] = graph_census(blob)
        log(f"  {label}: exported in {secs:.2f} s, {len(blob)} bytes"
            + (f"; graph {res[label]['graph']}" if census else ""))
        return blob

    blob = exported("cylinder f32 (card)", export_simulator, census=True, num_steps=len(times),
                    device="cuda", **export_call)
    if res["cylinder f32 (card)"]["graph"]["operators"] != want:
        raise AssertionError(f"the artefact's graph calls {res['cylinder f32 (card)']['graph']}"
                             f", expected {want}")
    ref = simulate(**call)
    paths = {k: os.path.join(workdir, f"export_{k}") for k in ("blob", "inputs", "ref", "out")}
    with open(paths["blob"], "wb") as fh:
        fh.write(blob)
    np.savez(paths["inputs"], times=times, v0=v0)
    paths["inputs"] += ".npz"
    np.save(paths["ref"], ref)
    paths["ref"] += ".npy"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", EXPORT_CHILD, paths["blob"], paths["inputs"],
                    paths["ref"], paths["out"]], cwd=os.path.dirname(os.path.abspath(__file__)),
                   check=True, timeout=900)
    child_s = time.perf_counter() - t0
    with open(paths["out"]) as fh:
        child = json.load(fh)
    per_call = {k: sum(n for name, n in child["device_kernels"].items()
                       if FORWARD_KERNELS[k] in name) for k in want}
    host_ms = float(np.median(child["walls_s"])) * 1e3 / steps
    log(f"  fresh process ({child_s:.1f} s in all): import {child['import_s']:.2f} s, load "
        f"{child['load_s']:.2f} s, first call {child['first_s']:.3f} s; launches "
        f"{child['launches']}; device kernels by the profiler {per_call}; device busy "
        f"{child['device_busy_ms']} ms a call; host {host_ms:.3f} ms per Euler step (median of "
        f"5 calls); modules of api, models, data, JAX: {child['banned_modules']}")
    if not child["same_bits"]:
        raise AssertionError("the fresh process's artefact differs from simulate's bits")
    if child["launches"] != want or per_call != want:
        raise AssertionError(f"the artefact launched {child['launches']} (profiler "
                             f"{per_call}), expected {want}")
    if child["banned_modules"]:
        raise AssertionError(f"the artefact's process imported {child['banned_modules']}")
    log("  cylinder f32 (card) in a fresh process: simulate's bits")

    # simulate's host ms and device busy ms in this process, beside the artefact's
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        simulate(**call)
        walls.append(time.perf_counter() - t0)
    events, sim_wall_ms = profiled(lambda: simulate(**call))
    sim_busy = sum(ev.time_range.elapsed_us() for ev in events) / 1e3
    sim_ms = float(np.median(walls)) * 1e3 / steps
    log(f"  simulate in this process: host {sim_ms:.3f} ms per Euler step (median of 5 calls), "
        f"device busy {sim_busy:.3f} ms a call; the artefact's device busy minus simulate's "
        f"{child['device_busy_ms'] - sim_busy:+.3f} ms a call")
    res["fresh_process"] = dict(child, host_ms_per_step=host_ms, process_s=child_s,
                                device_kernels_per_call=per_call)
    res["simulate"] = dict(host_ms_per_step=sim_ms, device_busy_ms=sim_busy,
                           profile_wall_ms=sim_wall_ms)

    # an artefact exported on the CPU, moved to the card at load, and the bf16
    # one: the first EXPORT_SHORT steps (an export takes about 4 s a step on the
    # card's host), against the 20-step card artefact's rows and bf16 simulate
    short = times[:EXPORT_SHORT + 1]
    blob_cpu = exported("cylinder f32 (cpu)", export_simulator, num_steps=len(short),
                        device="cpu", **export_call)
    t0 = time.perf_counter()
    moved = load_simulator(blob_cpu, device="cuda")
    load_s = time.perf_counter() - t0
    reset_counts()
    got = moved(short, v0)
    counts = {k: read_counts()[k] for k in want}
    want_short = {k: n * EXPORT_SHORT // steps for k, n in want.items()}
    log(f"  cylinder f32 (cpu) loaded onto the card in {load_s:.2f} s; launches {counts}")
    if counts != want_short:
        raise AssertionError(f"the moved artefact launched {counts}, expected {want_short}")
    same_bits(f"cylinder f32 exported on the cpu, run on the card, against the card "
              f"artefact's first {EXPORT_SHORT} steps", got, ref[:EXPORT_SHORT + 1])
    res["cylinder f32 (cpu)"]["load_s"] = load_s

    blob_bf = exported("cylinder bf16 (card)", export_simulator, num_steps=len(short),
                       device="cuda", compute_dtype="bfloat16", **export_call)
    same_bits("cylinder bf16 artefact against simulate(compute_dtype='bfloat16')",
              load_simulator(blob_bf, device="cuda")(short, v0),
              simulate(**dict(call, times=short), compute_dtype="bfloat16"))

    t0 = time.perf_counter()
    proc, flag_path = flag_job
    if proc.wait(timeout=1200) != 0:
        raise RuntimeError(f"the flag's export process exited {proc.returncode}")
    with open(flag_path + ".json") as fh:
        res["flag f32 (card)"] = json.load(fh)
    log(f"  flag f32 (card): exported in {res['flag f32 (card)']['export_s']:.2f} s by its own "
        f"process (waited {time.perf_counter() - t0:.2f} s for it here), "
        f"{res['flag f32 (card)']['bytes']} bytes")
    params, cfg = flag_model(fs)
    with open(flag_path, "rb") as fh:
        t0 = time.perf_counter()
        flag_sim = load_simulator(fh.read(), device="cuda")
    res["flag f32 (card)"]["load_s"] = time.perf_counter() - t0
    reset_counts()
    got = flag_sim(fs["times"], fs["wp"])
    counts = read_counts()
    log("  flag artefact's launches: " + json.dumps(
        {k: counts[k] for k in ("weight_streams", "edge_project", "edge_round",
                                "csr_segment_sum", "csr_segment_sum_perm", "node_round",
                                "node_round_extra")}))
    same_bits(f"flag f32 artefact against cloth_simulator over {FLAG['frames'] - 2} steps", got,
              cloth_simulator(params, fs["norm"], fs["pos"], fs["nt"], fs["cells"], cfg,
                              num_steps=FLAG["frames"])(fs["times"], fs["wp"]))
    res["flag f32 (card)"]["launches"] = counts
    return res


@contextlib.contextmanager
def background_flag_export():
    """The export phase's flag artefact made by ``--export-flag`` in a
    process of its own, started here; yields ``(process, artefact path)``
    and stops the process where the block leaves before it ended."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flag.pt2")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--export-flag",
                                 path], cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=subprocess.DEVNULL)
        try:
            yield proc, path
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def flag_model(fs) -> tuple:
    """The export phase's flag model: random f32 weights from seed 0 at full
    width, and its ClothConfig."""
    from mgn_tpu_torch.models.mgn_multi import init_mgn_multi
    from mgn_tpu_torch.train.cloth import ClothConfig, cloth_model_config

    cfg = ClothConfig(model=cloth_model_config(fs["meta"], LATENT, HIDDEN, MPS),
                      world_radius=FLAG["radius"], world_capacity=fs["capacity"])
    return init_mgn_multi(cfg.model, torch.Generator().manual_seed(0), device="cpu"), cfg


def export_flag(path: str) -> int:
    """``--export-flag PATH``: the export phase's flag artefact (the flag of
    flag_setup, flag_model's weights, 20 steps), exported on the card into
    PATH, its seconds and bytes into PATH.json."""
    from mgn_tpu_torch.serve import export_cloth_simulator

    fs = flag_setup()
    params, cfg = flag_model(fs)
    t0 = time.perf_counter()
    blob = export_cloth_simulator(params, fs["norm"], fs["pos"], fs["nt"], fs["cells"], cfg,
                                  num_steps=FLAG["frames"], device="cuda")
    secs = time.perf_counter() - t0
    with open(path, "wb") as fh:
        fh.write(blob)
    with open(path + ".json", "w") as fh:
        json.dump(dict(export_s=secs, bytes=len(blob)), fh)
    return 0


def host_time() -> int:
    """``--host-time``: simulate (20 Euler steps at full width on the
    1,900-node channel mesh) and the cylinder's derivative training step
    (20 frames of one trajectory a call), each on the host clock to the end
    of the device's work: one JSON line with the medians.  It uses only names
    the port has had since its training slice, so a copy of this file runs
    in a checkout of an earlier commit too: run there and here in turns in
    one call, it gives the operator route's host cost against that commit."""
    from mgn_tpu_torch import init_state
    from mgn_tpu_torch.data.pipeline import Trajectory

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["csr_segment", "fused_round", "fused_round_bwd", "wgrad"])
    with tempfile.TemporaryDirectory() as workdir:
        call = serving_call(workdir)
        simulate(**call)  # warm
        walls = []
        for _ in range(HOST_TIME["serve_calls"]):
            t0 = time.perf_counter()
            simulate(**call)
            walls.append(time.perf_counter() - t0)
        with open(os.path.join(workdir, "meta.json")) as fh:
            meta = json.load(fh)
    args = Args(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN)
    state, cfg, spec = init_state(meta, args, lambda ps: torch.optim.Adam(ps, lr=1e-4), "cuda")
    pos, cells, nt = make_channel_mesh(1900, seed=0)
    vel = make_trajectory(pos, nt, tl=STEPS + 1, dt=0.01, seed=1)
    traj = Trajectory(mesh_pos=pos, node_type=nt, times=np.arange(STEPS + 1, dtype=np.float32)
                      * 0.01, fields={"velocity": vel}, cells=cells, edges=None)
    prep = prepare_trajectory(traj, meta, spec, device="cuda")
    trainer = make_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.02,), norm_steps=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    perm = list(range(STEPS))
    trainer(state, prep.template, prep.fields, prep.times, perm[:2], gen)  # warm
    steps = []
    for _ in range(HOST_TIME["train_calls"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer(state, prep.template, prep.fields, prep.times, perm, gen)  # returns host losses
        steps.append((time.perf_counter() - t0) * 1e3 / len(perm))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=smi, torch=torch.__version__, tree=os.path.dirname(
        os.path.abspath(__file__)), serve_ms_per_step=float(np.median(walls)) * 1e3 / STEPS,
        serve_walls_s=walls, train_ms_per_step=float(np.median(steps)), train_ms=steps)))
    return 0


# --- phase 11g: the airfoil, deforming-plate and NS families ---------------------------

# family -> how the phase writes, trains and evaluates it: the DeepMind datasets' mean
# node counts (airfoil 5,233; deforming plate about 1,271: a 16 x 16 x 5 grid, 1,280),
# the training noise of tests/test_families.py (the examples' (10.0, 0.01) suits the
# real airfoil's velocities of hundreds of m/s, not the synthetic field's ~1), steps
# as one window (DerivativeTraining(window_size=steps)), and the Euler eval's steps
FAMILY_RUNS = {
    "airfoil": dict(tl=22, steps=20, eval_steps=5, noise=(0.01, 0.001), types_updated=(0, 5),
                    dtype="float32"),
    "plate": dict(tl=12, steps=10, eval_steps=11, noise=0.003, types_updated=(0, 6),
                  dtype="float32"),
    "ns": dict(tl=12, steps=5, eval_steps=11, noise=0.02, types_updated=(0, 5),
               dtype="bfloat16"),
}
# what a training step launches at E >= N (every family here): the defer_first backward
FAMILY_TRAIN = ("csr_segment_sum", "csr_segment_sum_perm", "edge_project", "edge_round",
                "node_round", "weight_streams", "edge_round_bwd_defer", "node_round_bwd",
                "wgrad", "first_layer_adjoint")
FAMILY_BF16_FORWARD = 5e-2  # bf16 rollout against the f32 CPU one: relative L2


def write_family(name: str, ds: str) -> None:
    from mgn_tpu_torch.data.ns import write_ns_tfrecord_dataset
    from mgn_tpu_torch.data.synthetic import (write_airfoil_tfrecord_dataset,
                                              write_plate_tfrecord_dataset)

    counts = dict(tl=FAMILY_RUNS[name]["tl"], n_train=1, n_valid=1, n_test=1, seed=0)
    if name == "airfoil":
        write_airfoil_tfrecord_dataset(ds, num_nodes=5233, **counts)
    elif name == "plate":
        write_plate_tfrecord_dataset(ds, dims=(16, 16, 5), **counts)
    else:  # the example's mesh, the solver cut to a 128 x 64 grid and 2.0 of spin-up
        write_ns_tfrecord_dataset(ds, num_nodes=1900, nx=128, ny=64, spin_up=2.0,
                                  verbose=False, **counts)


def read_export(path: str) -> dict:
    """Rollout 0's arrays of an eval export (.npz or .h5)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("0/")}
    import h5py

    with h5py.File(path, "r") as f:
        return {k: np.asarray(f["0"][k]) for k in f["0"]}


def leaf_names(tree, prefix: str = "") -> list:
    """The dotted path of every leaf of a parameter tree, in param_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix.rstrip(".")]


def frame_loss_grads_f64(params, norm, prep, t: int, cfg, spec, types_updated) -> list:
    """The witness of frame_loss_grads on the CPU: the same inputs and
    normalized targets (from the f32 path), the whole model in f64 from
    plain ops (encoders, process_rounds_f64, decoder, loss), rounded to no
    compute dtype: each f32 gradient's own error is its distance to this."""
    tcfg = DerivativeTrainerConfig(cfg, spec, (0.0,), types_updated=types_updated)
    tm = prep.template
    with torch.no_grad():
        noisy = type_mask(tm.node_type, tcfg.types_noisy) & tm.node_mask
        gen = torch.Generator().manual_seed(0)
        u, raw = frame_inputs(tcfg, prep.fields, prep.times, t, noisy, gen)
        target = torch.cat([norm.output[f](raw[f]) for f in spec.target_fields], dim=-1)
        graph = assemble_graph(norm, tm, u, spec)
    p = grad_copy(params, "cpu", torch.float64)

    def mlp(m, x):
        h = x
        for i in range(len(m["w"])):
            h = h @ m["w"][i] + m["b"][i]
            if i < len(m["w"]) - 1:
                h = torch.relu(h)
        if "ln_scale" in m:
            h = torch.nn.functional.layer_norm(h, h.shape[-1:], m["ln_scale"], m["ln_bias"],
                                               1e-5)
        return h

    v = mlp(p["node_encoder"], graph.node_features.double())
    e = mlp(p["edge_encoder"], graph.edge_features.double()) * tm.edge_mask.double()[:, None]
    v = process_rounds_f64(p["processor"], v, e, tm, cfg.message_passing_steps)
    pred = mlp(p["decoder"], v)
    loss = masked_mse(pred, target.double(), type_mask(tm.node_type, types_updated)
                      & tm.node_mask)
    return list(torch.autograd.grad(loss, param_leaves(p)))


def worst_leaves(got, ref, names, top: int = 3) -> list:
    """The ``top`` leaves with the largest share of entries outside rtol/atol
    5e-4 (check_grads' measure): name, shape, share, relative L2."""
    rows = []
    for a, b, n in zip(got, ref, names):
        bad, rel, _ = grad_stats([a], [b])
        rows.append((bad, rel, n, list(b.shape)))
    rows.sort(reverse=True)
    return [dict(leaf=n, shape=sh, share_outside=bad, rel_l2=rel)
            for bad, rel, n, sh in rows[:top]]


def family_case(workdir: str, name: str) -> dict:
    """One family on the card at full width (latent 128, 2 hidden layers, 15
    rounds): its TFRecord dataset, train_network for one window of
    ``steps`` derivative steps (every kernel of the defer_first path
    launched, by the counters), 3 more trainer steps under the guarded
    profiler (K1-K8 and weight_streams among the device kernels, device busy
    ms a step, idle share), eval_network's Euler rollout (its export read
    back) against the CPU plain path's rollout of the same checkpoint
    (f32: max |du| <= 1e-3; bf16: relative L2 <= 5e-2 of the f32 CPU
    rollout), and one frame's whole-model gradient by PERF.md section 2's
    rule against its f64 witness (frame_loss_grads_f64), beside the CPU
    plain path's distances to both (reported); bf16: against the CPU's bf16
    autograd, and check_bf16_accuracy against the f32 CPU gradient."""
    from mgn_tpu_torch import DerivativeTraining
    from mgn_tpu_torch.api import eval_network, eval_rollouts

    run = FAMILY_RUNS[name]
    ds, cp, out = (os.path.join(workdir, f"{name}_{k}") for k in ("ds", "cp", "out"))
    parts = {}
    t0 = time.perf_counter()
    write_family(name, ds)
    parts["write_s"] = time.perf_counter() - t0
    data = load_dataset(ds)
    meta, traj = data.meta, data.trajectory(0)
    t0 = time.perf_counter()
    tm = build_template(traj.mesh_pos, traj.node_type, cells=traj.cells, edges=traj.edges)
    parts["template_s"] = time.perf_counter() - t0
    sizes = dict(nodes=traj.num_nodes, edges=int(tm.edge_mask.sum()), n_pad=tm.num_nodes,
                 e_pad=tm.num_edges, targets=list(meta["target_features"]))
    log(f"  {name}: wrote {sizes} ({run['tl']} frames, 1 train + 1 valid + 1 test "
        f"trajectory) in {parts['write_s']:.2f} s; template {parts['template_s']:.3f} s")
    model = dict(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN,
                 types_updated=run["types_updated"], compute_dtype=run["dtype"])
    bf16 = run["dtype"] == "bfloat16"

    metrics = MetricsLogger(quiet=True)
    reset_counts()
    t0 = time.perf_counter()
    state, best = train_network(run["noise"], lambda ps: torch.optim.Adam(ps, lr=1e-4), ds, cp,
                                metrics=metrics, device=DEVICE, steps=run["steps"],
                                norm_steps=run["steps"] // 2, checkpoint=run["steps"],
                                solver_valid="euler", seed=0,
                                training_strategy=DerivativeTraining(window_size=run["steps"]),
                                **model)
    torch.cuda.synchronize()
    parts["train_s"] = time.perf_counter() - t0
    launches = read_counts()
    losses = [r["loss"] for r in metrics.records if r["kind"] in ("train", "valid")]
    log(f"  {name}: train_network {state.step} steps in {parts['train_s']:.2f} s, losses "
        f"{[round(x, 6) for x in losses]}; launches {launches}")
    missing = [k for k in FAMILY_TRAIN if launches[k] <= 0]
    if missing or any(launches[k] for k in THREE_PART):
        raise AssertionError(f"{name}: train_network launched {launches}; missing {missing}")
    steps = state.step
    if steps != run["steps"] or len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: step {steps}, losses {losses}")

    cfg, spec = build_model_config(meta, Args(**model))
    noise = run["noise"] if isinstance(run["noise"], tuple) else (run["noise"],)
    prep = prepare_trajectory(traj, meta, spec, device=DEVICE)
    trainer = make_derivative_trainer(DerivativeTrainerConfig(
        cfg, spec, noise, types_updated=run["types_updated"], norm_steps=0))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    trainer(state, prep.template, prep.fields, prep.times, [0, 1], gen)  # warm
    profile = profile_training(lambda: trainer(state, prep.template, prep.fields, prep.times,
                                               [2, 3, 4], gen), 3)
    parts["profile_s"] = time.perf_counter() - t0
    kernels = profile.get("device_kernels_per_step") or {}
    if profile.get("device_busy_ms_per_step") is None or not all(kernels.values()):
        raise AssertionError(f"{name}: the profiler's device kernels a step: {kernels}")

    dt = float(meta["dt"])
    kw = dict(solver="euler", stop=(run["eval_steps"] + 0.5) * dt, mse_steps=(1, run["eval_steps"]),
              num_rollouts=1, mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN,
              types_updated=run["types_updated"])
    elog = MetricsLogger(quiet=True)
    reset_counts()
    t0 = time.perf_counter()
    reports = eval_network(ds, cp, out, device=DEVICE, metrics=elog, compute_dtype=run["dtype"],
                           **kw)
    parts["eval_s"] = time.perf_counter() - t0
    calls = {k: read_counts()[k] for k in FORWARD}
    path = [r["path"] for r in elog.records if r["kind"] == "export"][-1]
    pred = read_export(path)["prediction"]
    t0 = time.perf_counter()
    _, ref_exports, _ = eval_rollouts(ds, cp, device="cpu", compute_dtype="float32", **kw)
    parts["cpu_rollout_s"] = time.perf_counter() - t0
    ref = ref_exports[0]["prediction"]
    max_abs = float(np.abs(pred - ref).max())
    rel = float(np.linalg.norm(pred - ref) / np.linalg.norm(ref))
    tol = f"relative L2 <= {FAMILY_BF16_FORWARD}" if bf16 else "max |du| <= 1e-3"
    log(f"  {name}: eval_network on {DEVICE} ({run['dtype']}): {pred.shape[0] - 1} Euler steps, "
        f"{reports[0]['steps_per_second']:.2f} steps/s, final_rmse "
        f"{reports[0]['final_rmse']:.6f}, export {os.path.basename(path)}; against the CPU f32 "
        f"rollout: max_abs_err {max_abs:.3e}, relative L2 {rel:.3e} ({tol}); launches {calls}")
    if (pred.shape != ref.shape or pred.shape[0] != run["eval_steps"] + 1
            or pred.shape[-1] != spec.output_dim or not np.isfinite(pred).all()
            or not all(calls.values())
            or not (rel <= FAMILY_BF16_FORWARD if bf16 else max_abs <= 1e-3)):
        raise AssertionError(f"{name}: eval on {DEVICE}: shape {pred.shape}, max_abs {max_abs}, "
                             f"rel {rel}, launches {calls}")

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    prep_cpu = to_cpu_prep(prep)
    tu = run["types_updated"]
    _, g_gpu = frame_loss_grads(grad_copy(state.params), state.norm, prep, 3, cfg32, spec, tu)
    g_gpu = [g.cpu() for g in g_gpu]
    norm_cpu = state.norm.to("cpu")
    _, g_cpu = frame_loss_grads(grad_copy(state.params, "cpu"), norm_cpu, prep_cpu, 3, cfg32,
                                spec, tu)
    # each f32 gradient against the f64 witness, and the leaves that decide the rule
    g64 = frame_loss_grads_f64(state.params, norm_cpu, prep_cpu, 3, cfg32, spec, tu)
    names = leaf_names(state.params)
    witness = {}
    for label, got, ref in (("kernels_vs_plain", g_gpu, g_cpu), ("kernels_vs_f64", g_gpu, g64),
                            ("plain_vs_f64", g_cpu, g64)):
        share, rel_g, max_g = grad_stats(got, ref)
        witness[label] = dict(share_outside=share, rel_l2=rel_g, max_abs_err=max_g,
                              median_err=median_error(got, ref),
                              worst=worst_leaves(got, ref, names))
    log(f"  {name} f32 gradient, worst leaves: " + json.dumps(witness))
    # the rule is held against the exact gradient: on the NS frame the CPU plain path
    # itself misses it there (PERF.md section 2), while the kernels meet it
    grads = {"float32": check_grads(f"{name} whole-model gradient, cuda vs the f64 witness",
                                    torch.float32, g_gpu, g64), "worst_leaves": witness}
    if bf16:
        _, g16 = frame_loss_grads(grad_copy(state.params), state.norm, prep, 3, cfg, spec, tu)
        _, g16_cpu = frame_loss_grads(grad_copy(state.params, "cpu"), state.norm.to("cpu"),
                                      prep_cpu, 3, cfg, spec, tu)
        g16 = [g.cpu() for g in g16]
        grads["bfloat16"] = dict(
            check_grads(f"{name} whole-model gradient bf16, cuda vs cpu plain path",
                        torch.bfloat16, g16, g16_cpu),
            **check_bf16_accuracy(f"{name} whole-model gradient", g16, g16_cpu, g_cpu))
    parts["grad_s"] = time.perf_counter() - t0
    log(f"  {name}: seconds by part {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    return dict(sizes=sizes, dtype=run["dtype"], steps=steps, losses=losses,
                launches=launches, profile=profile, eval=dict(
                    steps=int(pred.shape[0] - 1), steps_per_second=reports[0]["steps_per_second"],
                    final_rmse=reports[0]["final_rmse"], export=os.path.basename(path),
                    max_abs_err=max_abs, rel_l2=rel, launches=calls),
                grads=grads, seconds=parts)


def family_examples(workdir: str, flag_ds: str) -> dict:
    """The four example drivers' main(argv) in this process at full width, on
    the datasets the families phase and the cloth training phase wrote: 2
    training steps (no validation sweep: the examples validate by the
    adaptive Tsit5, which takes a bf16 model ~30 s of host tries), then the
    Euler (flag: semi-implicit) evaluation and its export; and the command
    line's ``synth --family airfoil`` and ``convert stats`` in this
    process."""
    from mgn_tpu_torch.__main__ import main as cli
    from mgn_tpu_torch.examples import airfoil, deforming_plate, flag_simple, ns_vortex

    res = {}
    small = ["--steps", "2", "--checkpoint", "1000", "--norm-steps", "1", "--num-rollouts", "1",
             "--mse-steps", "1", "5"]
    for name, example, ds, solver in (
            ("airfoil", airfoil, os.path.join(workdir, "airfoil_ds"), "euler"),
            ("deforming_plate", deforming_plate, os.path.join(workdir, "plate_ds"), "euler"),
            ("flag_simple", flag_simple, flag_ds, "semi_implicit"),
            ("ns_vortex", ns_vortex, os.path.join(workdir, "ns_ds"), "euler")):
        cp, out = (os.path.join(workdir, f"example_{name}_{k}") for k in ("cp", "out"))
        t0 = time.perf_counter()
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            example.main(["train", ds, cp, *small])
            example.main(["eval", ds, cp, out, *small])
        path = os.path.join(out, solver, export_name())
        res[name] = dict(s=time.perf_counter() - t0, export=os.path.isfile(path))
        log(f"  example {name}: train 2 steps and eval in {res[name]['s']:.2f} s, "
            f"{os.path.basename(path)} written: {res[name]['export']}")
        if not res[name]["export"]:
            raise AssertionError(f"example {name} wrote no {path}")
    t0 = time.perf_counter()
    d = os.path.join(workdir, "cli_airfoil")
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        cli(["synth", d, "--family", "airfoil", "--num-nodes", "500", "--tl", "6",
             "--n-train", "1", "--n-valid", "1", "--n-test", "1"])
        cli(["convert", "stats", d])
    stats = load_dataset(d).meta["features"]["density"]
    res["synth_airfoil_and_stats_s"] = time.perf_counter() - t0
    log(f"  synth --family airfoil and convert stats in this process: "
        f"{res['synth_airfoil_and_stats_s']:.2f} s; density output_min/max "
        f"{stats.get('output_min')}, {stats.get('output_max')}")
    if "output_min" not in stats:
        raise AssertionError(f"convert stats wrote no der_minmax: {stats}")
    return res


def phase_families(workdir: str, flag_ds: str) -> dict:
    """The airfoil (5,233 nodes), the deforming plate (1,280 nodes) and NS
    (bf16) through the kernels on the card (family_case each), then the
    examples (family_examples).  After every other phase."""
    from mgn_tpu_torch.ops import native

    log("phase families")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    route = native.route()
    res = {"edge_route": route, "native_load_s": time.perf_counter() - t0}
    log(f"  build_template's edge route: {route} (the native graph builder "
        f"{'loaded' if route == 'native' else 'did not load'} in {res['native_load_s']:.2f} s)")
    for name in FAMILY_RUNS:
        res[name] = family_case(workdir, name)
    res["examples"] = family_examples(workdir, flag_ds)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase families: {res['phase_s']:.2f} s wall")
    return res


# --- phase parallel: graph parallelism over torch.distributed -----------------------

# the cylinder model at full width on make_channel_mesh(5233, seed=0) (the airfoil's
# node count: a depth-15 ghost zone covers 3,840 of its rows a part at P = 2, a real
# subset), the cylinder writer's fields, tl 22, one trajectory a split
PARALLEL = dict(nodes=5233, tl=22, steps=10, norm_steps=2, serve_steps=20, saves=5,
                nccl_steps=5, lr=1e-4, exchange_steps=5)
# graph-parallel against single-device results on the card: rollouts max |du|, the
# training losses relative
PARALLEL_ROLLOUT_TOL, PARALLEL_LOSS_RTOL = 1e-3, 1e-3


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parallel_model() -> dict:
    return dict(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN, seed=0)


class StepLosses:
    """While entered, records the per-step losses of every trainer that
    ``module.<name>`` builds (the window's losses, which train_network logs
    only as a mean)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name

    def __enter__(self):
        self.losses, self.inner = [], getattr(self.module, self.name)

        def factory(*args, **kwargs):
            trainer = self.inner(*args, **kwargs)

            def run(*a, **k):
                state, losses = trainer(*a, **k)
                self.losses.extend(float(x) for x in losses)
                return state, losses
            return run

        setattr(self.module, self.name, factory)
        return self.losses

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def gloo_collectives(device) -> dict:
    """Which collectives the group's backend takes on ``device``'s tensors:
    each called once on a small tensor (a check; the exchange itself catches
    nothing)."""
    import torch.distributed as dist

    n, x = dist.get_world_size(), torch.arange(8.0, device=device)
    calls = {
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * n, device=device), x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // n, device=device), x),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = "takes"
        except (RuntimeError, ValueError) as e:
            out[name] = f"refuses: {str(e)[:120]}"
    return out


def parallel_setup(workdir: str, device):
    """What both parallel ranks' checks read: the dataset's test and train
    trajectories, the model config and spec, the checkpoint's (params,
    norm) on ``device``."""
    from mgn_tpu_torch.checkpoint.manager import load_model

    ds = os.path.join(workdir, "parallel_ds")
    test = load_dataset(ds, is_training=False).trajectory(0)
    train = load_dataset(ds).trajectory(0)
    meta = load_dataset(ds).meta
    args = Args(**parallel_model()).resolve_auto()
    cfg, spec = build_model_config(meta, args)
    params, norm = load_model(os.path.join(workdir, "parallel_cp"), False, device)
    return dict(ds=ds, test=test, train=train, meta=meta, args=args, cfg=cfg, spec=spec,
                params=params, norm=norm)


def initial_params(cfg, device):
    """init_state's parameters for seed 0, leaves needing a gradient."""
    params = init_mgn(cfg, torch.Generator().manual_seed(0), device=device)
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params


def sharded_frame_grads(params, norm, shard, t: int, cfg, spec, mesh):
    """frame_loss_grads' loss and whole-model gradient on a graph-parallel
    part: the loss over the global count of updated nodes, the gradient
    summed over the world (the SPMD step's, without accumulation or
    update)."""
    from mgn_tpu_torch.parallel.halo import apply_shard
    from mgn_tpu_torch.parallel.spmd import _sum_grads, shard_features

    tcfg = DerivativeTrainerConfig(cfg, spec, (0.0,))
    g = shard.graph
    with torch.no_grad():
        noisy = type_mask(g.node_type, tcfg.types_noisy) & g.node_mask
        gen = torch.Generator(device=shard.times.device).manual_seed(0)
        u, raw = frame_inputs(tcfg, shard.fields, shard.times, t, noisy, gen)
        target = torch.cat([norm.output[f](raw[f]) for f in spec.target_fields], dim=-1)
        nf = shard_features(norm, g, u, spec)
        upd = (type_mask(g.node_type, tcfg.types_updated) & g.node_mask).float()
        count = mesh.world.all_reduce(upd.sum().reshape(1))
    out = apply_shard(params, nf, norm.edge, g, cfg, mesh.graph_comm)
    loss = (((out - target) ** 2).sum(-1) * upd).sum() / torch.clamp(count[0], min=1.0)
    leaves = param_leaves(params)
    for p in leaves:
        p.grad = None
    loss.backward()
    _sum_grads(leaves, mesh.world)
    return mesh.world.all_reduce(loss.detach().reshape(1))[0], [p.grad for p in leaves]


def parallel_nccl_rank(rank: int, workdir: str, device: str, backend: str,
                       sizes: dict) -> dict:
    """Mesh (1, 1) over ``backend``: one sharded derivative step from the
    initial state (make_spmd_derivative_step) and a short sharded Euler
    rollout from the checkpoint (make_sharded_rollout_fn), with every count
    set to 0 before and read after."""
    from mgn_tpu_torch.api_spmd import GraphPlanner
    from mgn_tpu_torch.parallel.mesh import make_device_mesh
    from mgn_tpu_torch.parallel.rollout import (gather_prediction, make_sharded_rollout_fn,
                                                unpermute_sharded)
    from mgn_tpu_torch.parallel.spmd import make_spmd_derivative_step

    t0 = time.perf_counter()
    dev = torch.device(device)
    mesh = make_device_mesh(1, 1, backend, dev)
    c = parallel_setup(workdir, dev)
    planner = GraphPlanner(c["meta"], c["args"], mesh)
    shard, _ = planner.shard("train", c["train"])
    test_shard, pt = planner.shard("test", c["test"])
    _, e_norm, n_norms, o_norms = N.normalizers_from_meta(c["meta"], c["args"].max_norm_steps)
    params = initial_params(c["cfg"], dev)
    before = [p.detach().clone() for p in param_leaves(params)]
    state = TrainState(params, torch.optim.SGD(param_leaves(params), lr=1.0),
                       NormState(e_norm, n_norms, o_norms).to(dev), 0)
    step = make_spmd_derivative_step(mesh, c["cfg"], c["spec"], (0.0,), norm_steps=0)
    rollout = make_sharded_rollout_fn(mesh.graph_comm, c["cfg"], c["spec"], "euler",
                                      forced=False)
    n = sizes["nccl_steps"]
    reset_counts()
    _, losses = step(state, shard, np.zeros((1, 1), np.int64), 0)
    with torch.no_grad():
        pred, _ = rollout(c["params"], c["norm"], test_shard.graph,
                          {f: v[:1] for f, v in test_shard.fields.items()},
                          test_shard.times[:n + 1], test_shard.times[:1])
    full = unpermute_sharded(pt, gather_prediction(pred, mesh.graph_comm), c["test"].num_nodes)
    sync(dev)
    return dict(loss=float(losses[0]),
                update=[(b - p.detach()).cpu() for b, p in zip(before, param_leaves(params))],
                pred=full, launches=read_counts(), exchange=mesh.graph_comm.stats,
                world=mesh.world.stats, seconds=time.perf_counter() - t0,
                rows=dict(part_nodes=pt.part_nodes, n_ext=pt.deep.n_ext,
                          e_ext=pt.deep.senders.shape[1]))


def parallel_rank(rank: int, workdir: str, device: str, sizes: dict) -> dict:
    """One rank of mesh (1, 2) over gloo, both ranks on ``device``:
    simulate(graph_parallel=2) deep and classic, train_network for
    sizes['steps'] noise-free steps, eval_network with the adaptive Tsit5,
    one frame's whole-model gradient, then profiles of a training and a
    serving step and the exchange's bytes and host ms."""
    import mgn_tpu_torch.api_spmd as api_spmd
    import mgn_tpu_torch.parallel.rollout as prollout
    from mgn_tpu_torch import DerivativeTraining
    from mgn_tpu_torch.api import eval_network
    from mgn_tpu_torch.parallel.mesh import make_device_mesh
    from mgn_tpu_torch.parallel.spmd import make_spmd_derivative_step

    dev = torch.device(device)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # two ranks share the host
    parts, res = {}, {"rank": rank}
    t_rank = t0 = time.perf_counter()
    res["collectives"] = gloo_collectives(dev)
    c = parallel_setup(workdir, dev)
    parts["setup_s"] = time.perf_counter() - t0
    test, model = c["test"], parallel_model()
    call = dict(meta_dir=c["ds"], cp_path=os.path.join(workdir, "parallel_cp"),
                mesh_pos=test.mesh_pos, node_type=test.node_type,
                initial_fields={"velocity": test.fields["velocity"][0]},
                times=test.times[:sizes["serve_steps"] + 1], cells=test.cells,
                solver="euler", device=dev, graph_parallel=2, use_valid=False, **model)
    for form, kw in (("deep", {}), ("classic", {"halo_rounds": 0})):
        reset_counts()
        t0 = time.perf_counter()
        res[f"simulate_{form}"] = simulate(**call, **kw)
        sync(dev)
        parts[f"simulate_{form}_s"] = time.perf_counter() - t0
        res[f"simulate_{form}_launches"] = read_counts()

    t0 = time.perf_counter()
    with StepLosses(api_spmd, "make_spmd_derivative_step") as losses:
        reset_counts()
        train_network(0.0, lambda ps: torch.optim.Adam(ps, lr=sizes["lr"]), c["ds"],
                      os.path.join(workdir, "parallel_cp_gp"), device=dev, graph_parallel=2,
                      steps=sizes["steps"], norm_steps=sizes["norm_steps"],
                      checkpoint=sizes["steps"], solver_valid="euler",
                      training_strategy=DerivativeTraining(window_size=sizes["steps"],
                                                           random=False),
                      metrics=MetricsLogger(quiet=True), **model)
        sync(dev)
    parts["train_s"] = time.perf_counter() - t0
    res["train_losses"], res["train_launches"] = list(losses), read_counts()

    t0 = time.perf_counter()
    saves = test.times[:sizes["saves"] + 1]
    with AdaptiveStats() as calls:
        reset_counts()
        elog = MetricsLogger(quiet=True)
        reports = eval_network(c["ds"], os.path.join(workdir, "parallel_cp"),
                               os.path.join(workdir, "parallel_eval"), solver="tsit5_adaptive",
                               saves=saves, num_rollouts=1, device=dev, graph_parallel=2,
                               metrics=elog, use_valid=False, **model)
        sync(dev)
    parts["eval_s"] = time.perf_counter() - t0
    res["eval_tries"], res["eval_launches"] = calls[0]["tries"], read_counts()
    res["eval_final_rmse"] = reports[0]["final_rmse"]
    if rank == 0:
        path = [r["path"] for r in elog.records if r["kind"] == "export"][-1]
        res["eval_pred"] = read_export(path)["prediction"]

    # one frame's whole-model gradient, the profiles and the exchange, on a mesh of
    # this function's own (the entry points make theirs inside)
    t0 = time.perf_counter()
    mesh = make_device_mesh(1, 2, "gloo", dev)
    planner = api_spmd.GraphPlanner(c["meta"], c["args"], mesh)
    shard, _ = planner.shard("train", c["train"])
    params = initial_params(c["cfg"], dev)
    loss, grads = sharded_frame_grads(params, c["norm"], shard, 0, c["cfg"], c["spec"], mesh)
    res["grad_loss"], res["grads"] = float(loss), [g.cpu() for g in grads]
    parts["grad_s"] = time.perf_counter() - t0

    if dev.type != "cuda":  # a CPU rehearsal: no device profiles
        res["seconds"], res["rank_s"] = parts, time.perf_counter() - t_rank
        return res
    t0 = time.perf_counter()
    state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=sizes["lr"]),
                       c["norm"], 0)
    step = make_spmd_derivative_step(mesh, c["cfg"], c["spec"], (0.0,), norm_steps=0)
    step(state, shard, np.array([[0], [1]]), 0)  # warm
    res["train_profile"] = profile_training(
        lambda: step(state, shard, np.array([[2], [3], [4]]), 0), 3)
    test_shard, _ = planner.shard("test", test)
    rollout = prollout.make_sharded_rollout_fn(mesh.graph_comm, c["cfg"], c["spec"], "euler",
                                               forced=False)
    n = sizes["exchange_steps"]

    def serve(steps: int):
        with torch.no_grad():
            return rollout(c["params"], c["norm"], test_shard.graph,
                           {f: v[:1] for f, v in test_shard.fields.items()},
                           test_shard.times[:steps + 1], test_shard.times[:1])

    serve(1)  # warm
    res["serve_profile"] = profile_training(lambda: serve(n), n)
    torch.distributed.barrier()  # the ranks start the timed exchanges together
    mesh.graph_comm.stats.clear()
    serve(n)
    sync(dev)
    res["exchange"] = dict(mesh.graph_comm.stats)
    parts["profile_s"] = time.perf_counter() - t0
    res["seconds"], res["rank_s"] = parts, time.perf_counter() - t_rank
    return res


def phase_parallel(workdir: str, device: str = "cuda", sizes: dict = PARALLEL,
                   nccl: str = "nccl") -> dict:
    """Graph parallelism on the card (mgn_tpu_torch.parallel, api_spmd),
    after every other phase: mesh (1, 1) over NCCL and mesh (1, 2) over gloo
    (two ranks sharing the card), each rank a process of its own
    (mgn_tpu_torch.parallel.mesh.spawn), held against the single-device path
    run here first."""
    from mgn_tpu_torch import DerivativeTraining
    from mgn_tpu_torch.api import eval_rollouts
    from mgn_tpu_torch.parallel.mesh import spawn
    from mgn_tpu_torch.rollout.evaluate import make_rollout_fn

    log("phase parallel")
    rank_device = "cuda:0" if device == "cuda" else device
    t_phase = t0 = time.perf_counter()
    parts, res = {}, {}
    ds, cp = os.path.join(workdir, "parallel_ds"), os.path.join(workdir, "parallel_cp")
    write_synthetic_tfrecord_dataset(ds, num_nodes=sizes["nodes"], tl=sizes["tl"],
                                     n_train=1, n_valid=1, n_test=1)
    parts["write_s"] = time.perf_counter() - t0
    model = parallel_model()

    # the single-device references on the card
    t0 = time.perf_counter()
    with StepLosses(sys.modules["mgn_tpu_torch.api"], "make_derivative_trainer") as ref_losses:
        train_network(0.0, lambda ps: torch.optim.Adam(ps, lr=sizes["lr"]), ds, cp,
                      device=device, steps=sizes["steps"], norm_steps=sizes["norm_steps"],
                      checkpoint=sizes["steps"], solver_valid="euler",
                      training_strategy=DerivativeTraining(window_size=sizes["steps"],
                                                           random=False),
                      metrics=MetricsLogger(quiet=True), **model)
    c = parallel_setup(workdir, torch.device(device))
    test = c["test"]
    ref_sim = simulate(ds, cp, test.mesh_pos, test.node_type,
                       {"velocity": test.fields["velocity"][0]},
                       test.times[:sizes["serve_steps"] + 1], cells=test.cells,
                       solver="euler", device=device, use_valid=False, **model)
    saves = test.times[:sizes["saves"] + 1]
    with AdaptiveStats() as calls:
        _, ref_eval, _ = eval_rollouts(ds, cp, solver="tsit5_adaptive", saves=saves,
                                       num_rollouts=1, device=device, use_valid=False, **model)
    ref_tries = calls[0]["tries"]
    prep = prepare_trajectory(c["train"], c["meta"], c["spec"], device=device)
    _, ref_grads = frame_loss_grads(initial_params(c["cfg"], device), c["norm"], prep, 0,
                                    c["cfg"], c["spec"])
    # one single-device step from the initial state (the NCCL rank's step), by SGD with
    # lr 1: the update is the step's gradient
    _, e_norm, n_norms, o_norms = N.normalizers_from_meta(c["meta"], c["args"].max_norm_steps)
    params = initial_params(c["cfg"], device)
    before = [p.detach().clone() for p in param_leaves(params)]
    state = TrainState(params, torch.optim.SGD(param_leaves(params), lr=1.0),
                       NormState(e_norm, n_norms, o_norms).to(device), 0)
    trainer = make_derivative_trainer(DerivativeTrainerConfig(c["cfg"], c["spec"], (0.0,),
                                                              norm_steps=0))
    _, step_loss = trainer(state, prep.template, prep.fields, prep.times, [0],
                           torch.Generator(device=device).manual_seed(0))
    step_update = [(b - p.detach()).cpu() for b, p in zip(before, param_leaves(params))]
    if device == "cuda":  # the single-device step's and serving step's device time
        state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=sizes["lr"]),
                           c["norm"], 0)
        gen = torch.Generator(device=device).manual_seed(0)
        trainer(state, prep.template, prep.fields, prep.times, [1], gen)  # warm
        res["single_train_profile"] = profile_training(
            lambda: trainer(state, prep.template, prep.fields, prep.times, [2, 3, 4], gen), 3)
        test_prep = prepare_trajectory(test, c["meta"], c["spec"], device=device)
        rollout = make_rollout_fn(c["cfg"], c["spec"], "euler", forced=False)
        n = sizes["exchange_steps"]

        def serve():
            with torch.no_grad():
                return rollout(c["params"], c["norm"], test_prep.template,
                               {f: v[:1] for f, v in test_prep.fields.items()},
                               test_prep.times[:n + 1], test_prep.times[:1])

        serve()  # warm
        res["single_serve_profile"] = profile_training(serve, n)
    sync(torch.device(device))
    parts["single_device_s"] = time.perf_counter() - t0
    log(f"  {sizes['nodes']} nodes, tl {sizes['tl']}: single-device references on the "
        f"card in {parts['single_device_s']:.2f} s (train_network losses "
        f"{[round(x, 6) for x in ref_losses]}, adaptive tries {ref_tries})")

    # mesh (1, 1), one rank over NCCL
    t0 = time.perf_counter()
    (one,) = spawn(1, parallel_nccl_rank, (workdir, rank_device, nccl, sizes), backend=nccl)
    parts["nccl_s"] = time.perf_counter() - t0
    n = sizes["nccl_steps"]
    pred_bits = bool(np.array_equal(one["pred"], ref_sim[:n + 1]))
    pred_err = float(np.abs(one["pred"] - ref_sim[:n + 1]).max())
    step_rel = abs(one["loss"] - float(step_loss[0])) / abs(float(step_loss[0]))
    update_bits = all(torch.equal(a, b) for a, b in zip(one["update"], step_update))
    log(f"  mesh (1, 1), nccl: {parts['nccl_s']:.2f} s (the rank's own {one['seconds']:.2f} s; "
        f"part {one['rows']}); one sharded derivative step: loss {one['loss']:.6f} against the "
        f"single-device step's {float(step_loss[0]):.6f} (relative {step_rel:.2e}), the update "
        f"(the gradient, SGD lr 1) the same bits {update_bits}; {n}-step sharded Euler rollout "
        f"against simulate's first {n} steps: the same bits {pred_bits}, max |du| "
        f"{pred_err:.3e}; launches {one['launches']}; exchange {one['exchange']}")
    update = check_grads("mesh (1, 1) step's update against the single-device step's",
                         torch.float32, one["update"], step_update)
    counted = device == "cuda"  # the counters count kernel launches (none in a CPU rehearsal)
    if not (pred_err <= PARALLEL_ROLLOUT_TOL and step_rel <= PARALLEL_LOSS_RTOL
            and (not counted or all(one["launches"][k] > 0 for k in FAMILY_TRAIN))):
        raise AssertionError(f"mesh (1, 1): rollout {pred_err:.3e}, step loss {step_rel:.2e}, "
                             f"launches {one['launches']}")

    # mesh (1, 2), two ranks over gloo sharing the card
    t0 = time.perf_counter()
    ranks = spawn(2, parallel_rank, (workdir, rank_device, sizes), backend="gloo")
    parts["gloo_s"] = time.perf_counter() - t0
    out = {}
    for form in ("deep", "classic"):
        errs = [float(np.abs(r[f"simulate_{form}"] - ref_sim).max()) for r in ranks]
        same = bool(np.array_equal(ranks[0][f"simulate_{form}"], ranks[1][f"simulate_{form}"]))
        out[f"simulate_{form}"] = dict(max_abs_err=max(errs), ranks_same=same,
                                       seconds=[r["seconds"][f"simulate_{form}_s"]
                                                for r in ranks])
        log(f"  simulate(graph_parallel=2), {form} halo, {sizes['serve_steps']} Euler steps: "
            f"max |du| against simulate {max(errs):.3e} (tolerance {PARALLEL_ROLLOUT_TOL}), the "
            f"ranks' results the same {same}, seconds by rank {out[f'simulate_{form}']['seconds']}")
        launched = [r[f"simulate_{form}_launches"] for r in ranks]
        if not (max(errs) <= PARALLEL_ROLLOUT_TOL and same) or (counted and any(
                c[k] <= 0 for c in launched for k in FORWARD)):
            raise AssertionError(f"simulate(graph_parallel=2) {form}: {errs}, same {same}, "
                                 f"launches {launched}")
    losses = [r["train_losses"] for r in ranks]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], ref_losses)]
    log(f"  train_network(graph_parallel=2), {sizes['steps']} noise-free steps: losses "
        f"{[round(x, 6) for x in losses[0]]} against single-device {[round(x, 6) for x in ref_losses]}"
        f" (worst relative {max(rel):.2e}, tolerance {PARALLEL_LOSS_RTOL}); the ranks' losses "
        f"the same {losses[0] == losses[1]}")
    if not (len(losses[0]) == len(ref_losses) == sizes["steps"] and losses[0] == losses[1]
            and max(rel) <= PARALLEL_LOSS_RTOL):
        raise AssertionError(f"train_network(graph_parallel=2) losses {losses} against "
                             f"{ref_losses}")
    for r in ranks:
        missing = [k for k in FAMILY_TRAIN if r["train_launches"][k] <= 0]
        if missing and counted:
            raise AssertionError(f"rank {r['rank']}: train_network launched {r['train_launches']}")
    eval_err = float(np.abs(ranks[0]["eval_pred"] - ref_eval[0]["prediction"]).max())
    tries = [r["eval_tries"] for r in ranks]
    log(f"  eval_network(graph_parallel=2), adaptive Tsit5 over {sizes['saves']} save "
        f"intervals: (accepted, rejected) tries per interval by rank {tries}, single-device "
        f"{ref_tries}; max |du| against the single-device rollout {eval_err:.3e}")
    if not (tries[0] == tries[1] and eval_err <= PARALLEL_ROLLOUT_TOL):
        raise AssertionError(f"eval_network(graph_parallel=2): tries {tries}, err {eval_err:.3e}")
    g_ranks = ranks[0]["grads"]
    grads = check_grads("one frame's whole-model gradient, graph_parallel=2 vs single device",
                        torch.float32, g_ranks, [g.cpu() for g in ref_grads])
    for r in ranks:
        if "train_profile" not in r:
            continue
        prof_t, prof_s = r["train_profile"], r["serve_profile"]
        kernels = prof_t.get("device_kernels_per_step") or {}
        if prof_t.get("device_busy_ms_per_step") is None or not all(kernels.values()):
            raise AssertionError(f"rank {r['rank']}: the training step's device kernels "
                                 f"{kernels}")
        ex = r["exchange"].get("all_to_all_single", [0, 0, 0.0])
        log(f"  rank {r['rank']}: gloo on CUDA tensors {r['collectives']}; training step device "
            f"busy {prof_t['device_busy_ms_per_step']:.3f} ms, idle share "
            f"{prof_t['idle_share']:.4f}, kernels a step {kernels}; serving step device busy "
            f"{prof_s.get('device_busy_ms_per_step')} ms, idle share {prof_s.get('idle_share')};"
            f" exchange over {sizes['exchange_steps']} serving steps: {ex[0]} all_to_all "
            f"calls, {ex[1] / max(ex[0], 1):.0f} bytes and {ex[2] / max(ex[0], 1):.3f} host ms "
            f"each; seconds {json.dumps({k: round(v, 2) for k, v in r['seconds'].items()})}, "
            f"{r['rank_s']:.2f} s in all")
    res.update(out, nccl=dict(pred_bits=pred_bits, max_abs_err=pred_err, step_loss_rel=step_rel,
                              update_bits=update_bits, update=update, launches=one["launches"],
                              exchange=one["exchange"], rows=one["rows"]),
               train=dict(losses=losses[0], ref_losses=ref_losses, worst_rel=max(rel)),
               eval=dict(tries=tries, ref_tries=ref_tries, max_abs_err=eval_err),
               grads=grads,
               ranks=[{k: r.get(k) for k in ("collectives", "train_profile", "serve_profile",
                                             "exchange", "seconds", "rank_s", "train_launches",
                                             "simulate_deep_launches",
                                             "simulate_classic_launches", "eval_launches")}
                      for r in ranks])
    parts["phase_s"] = time.perf_counter() - t_phase
    res["seconds"] = parts
    log(f"  phase parallel: {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    return res


# --- phase parallel train: graph-parallel solver training, telescoped stages, cloth --------

# after phase_parallel, on its dataset and checkpoint: the solver path's train_network steps
# over 5 Euler save intervals; the telescope's 3 stages (5, 5, 5) of the 15-round segment and
# its serving steps; the flag (50 x 32) written with 12 frames, trained 3 steps and evaluated
# over its 10 rollout steps
PARALLEL_TRAIN = dict(solver_steps=3, saves=5, shooting=3, tsit5_saves=2, serve_steps=20,
                      telescope=3, flag=(FLAG["nx"], FLAG["ny"]), flag_tl=12, cloth_steps=3,
                      profile_steps=2, lr=1e-4)


class BoundedTries:
    """Records the (accepted, rejected) tries per interval of every bounded
    adaptive Tsit5 solve the solver trainers make while entered (one list a
    solve)."""

    def __enter__(self):
        import mgn_tpu_torch.train.solver as solver

        self.module, self.inner, self.calls = solver, solver.odeint_tsit5_bounded, []

        def record(*args, **kwargs):
            stats = []
            self.calls.append(stats)
            return self.inner(*args, stats=stats, **kwargs)

        solver.odeint_tsit5_bounded = record
        return self.calls

    def __exit__(self, *exc):
        self.module.odeint_tsit5_bounded = self.inner


def solver_strategies(meta, sizes: dict) -> dict:
    """The phase's solver strategies on the data's dt: Euler with remat over
    ``saves`` intervals, the bounded Tsit5 over ``tsit5_saves``, and
    MultipleShooting (Euler) in windows of ``shooting`` save points."""
    from mgn_tpu_torch.train.strategies import MultipleShooting, SolverTraining

    dt = float(meta["dt"])
    return {"euler": SolverTraining(0.0, dt, sizes["saves"] * dt, solver="euler", remat=True),
            "tsit5": SolverTraining(0.0, dt, sizes["tsit5_saves"] * dt,
                                    solver="tsit5_adaptive", remat=True),
            "shooting": MultipleShooting(0.0, dt, sizes["saves"] * dt,
                                         interval_size=sizes["shooting"], solver="euler")}


def fresh_norm(c, device) -> NormState:
    _, e_norm, n_norms, o_norms = N.normalizers_from_meta(c["meta"], c["args"].max_norm_steps)
    return NormState(e_norm, n_norms, o_norms).to(device)


def comm_stats(mesh) -> dict:
    """The group's and the world's collectives since their last clear: per
    name calls, bytes this rank sent and host ms."""
    return {"graph": {k: list(v) for k, v in mesh.graph_comm.stats.items()},
            "world": {k: list(v) for k, v in mesh.world.stats.items()}}


def clear_stats(mesh) -> None:
    mesh.graph_comm.stats.clear()
    mesh.world.stats.clear()


def sharded_solver_steps(mesh, c, shard, strategies, dev) -> dict:
    """One make_spmd_solver_step step of each strategy from the initial
    parameters (SGD lr 1, no warm-up): the summed loss, the summed gradient
    (left in the leaves' .grad) and, for the bounded Tsit5, the tries."""
    from mgn_tpu_torch.parallel.spmd import make_spmd_solver_step

    out = {}
    for name, strategy in strategies.items():
        params = initial_params(c["cfg"], dev)
        state = TrainState(params, torch.optim.SGD(param_leaves(params), lr=1.0),
                           fresh_norm(c, dev), 0)
        step = make_spmd_solver_step(mesh, c["cfg"], c["spec"], strategy, norm_steps=0)
        with BoundedTries() as tries:
            _, loss = step(state, shard)
        out[name] = dict(loss=float(loss[0]), tries=tries,
                         grads=[p.grad.detach().cpu() for p in param_leaves(params)])
    return out


def parallel_train_nccl_rank(rank: int, workdir: str, device: str, backend: str,
                             sizes: dict) -> dict:
    """Mesh (1, 1) over ``backend``: one sharded Euler solver step from the
    initial state, with every count set to 0 before and read after."""
    from mgn_tpu_torch.api_spmd import GraphPlanner
    from mgn_tpu_torch.parallel.mesh import make_device_mesh

    t0 = time.perf_counter()
    dev = torch.device(device)
    mesh = make_device_mesh(1, 1, backend, dev)
    c = parallel_setup(workdir, dev)
    shard, _ = GraphPlanner(c["meta"], c["args"], mesh).shard("train", c["train"])
    strategy = solver_strategies(c["meta"], sizes)["euler"]
    reset_counts()
    res = sharded_solver_steps(mesh, c, shard, {"euler": strategy}, dev)["euler"]
    sync(dev)
    return dict(res, launches=read_counts(), seconds=time.perf_counter() - t0)


def parallel_train_rank(rank: int, workdir: str, device: str, sizes: dict, cloth: dict) -> dict:
    """One rank of mesh (1, 2) over gloo, both ranks on ``device``: the
    solver path (train_network with SolverTraining, then one step of each
    strategy), the telescoped stages (simulate and one frame's gradient,
    telescoped and not) and the cloth family (train_network, the parts'
    world edges, eval_network), each with its launches, a profiled step and
    the collectives' bytes and host ms."""
    import mgn_tpu_torch.api_cloth as api_cloth
    import mgn_tpu_torch.api_spmd as api_spmd
    from mgn_tpu_torch import DerivativeTraining
    from mgn_tpu_torch.api import eval_network
    from mgn_tpu_torch.parallel import cloth as C
    from mgn_tpu_torch.parallel.mesh import make_device_mesh
    from mgn_tpu_torch.parallel.spmd import make_spmd_derivative_step, make_spmd_solver_step
    from mgn_tpu_torch.train.cloth import make_cloth_norm_state

    dev = torch.device(device)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # two ranks share the host
    counted = dev.type == "cuda"
    res, parts, t_rank = {"rank": rank}, {}, time.perf_counter()
    c = parallel_setup(workdir, dev)
    model = parallel_model()
    strategies = solver_strategies(c["meta"], sizes)
    mesh = make_device_mesh(1, 2, "gloo", dev)

    # (a) graph-parallel solver training
    t0 = time.perf_counter()
    with StepLosses(api_spmd, "make_spmd_solver_step") as losses:
        reset_counts()
        train_network(0.0, lambda ps: torch.optim.Adam(ps, lr=sizes["lr"]), c["ds"],
                      os.path.join(workdir, "pt_solver_cp_gp"), device=dev, graph_parallel=2,
                      steps=sizes["solver_steps"], norm_steps=0, checkpoint=10 ** 6,
                      training_strategy=strategies["euler"], metrics=MetricsLogger(quiet=True),
                      **model)
        sync(dev)
    res["solver_losses"], res["solver_launches"] = list(losses), read_counts()
    parts["solver_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    planner = api_spmd.GraphPlanner(c["meta"], c["args"], mesh)
    shard, _ = planner.shard("train", c["train"])
    res["solver_part_nodes"] = int(shard.graph.node_mask.shape[0])
    res["solver_steps"] = sharded_solver_steps(mesh, c, shard, strategies, dev)
    parts["solver_steps_s"] = time.perf_counter() - t0
    if counted:
        params = initial_params(c["cfg"], dev)
        state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=sizes["lr"]),
                           fresh_norm(c, dev), 0)
        step = make_spmd_solver_step(mesh, c["cfg"], c["spec"], strategies["euler"])
        step(state, shard)  # warm
        torch.distributed.barrier()
        res["solver_profile"] = profile_training(
            lambda: [step(state, shard) for _ in range(sizes["profile_steps"])],
            sizes["profile_steps"])
        clear_stats(mesh)
        step(state, shard)
        sync(dev)
        res["solver_exchange"] = comm_stats(mesh)

    # (b) the telescoped deep stages
    t0 = time.perf_counter()
    test = c["test"]
    call = dict(meta_dir=c["ds"], cp_path=os.path.join(workdir, "parallel_cp"),
                mesh_pos=test.mesh_pos, node_type=test.node_type,
                initial_fields={"velocity": test.fields["velocity"][0]},
                times=test.times[:sizes["serve_steps"] + 1], cells=test.cells,
                solver="euler", device=dev, graph_parallel=2, use_valid=False, **model)
    res["simulate_deep"] = simulate(**call)
    reset_counts()
    res["simulate_telescope"] = simulate(**call, telescope_stages=sizes["telescope"])
    targs = dataclasses.replace(c["args"], telescope_stages=sizes["telescope"])
    tplanner = api_spmd.GraphPlanner(c["meta"], targs, mesh)
    tshard, _ = tplanner.shard("train", c["train"])
    loss, grads = sharded_frame_grads(initial_params(c["cfg"], dev), c["norm"], tshard, 0,
                                      c["cfg"], c["spec"], mesh)
    sync(dev)
    res["telescope_launches"] = read_counts()
    res["telescope_grad_loss"], res["telescope_grads"] = float(loss), [g.cpu() for g in grads]
    g = tshard.graph
    res["telescope_rows"] = dict(
        part_nodes=int(g.node_mask.shape[0]),
        ext=(g.tables.rows, int(g.tables.senders.shape[0])),
        stages=[(st.rounds, st.tables.rows, int(st.tables.senders.shape[0])) for st in g.stages])
    parts["telescope_s"] = time.perf_counter() - t0
    if counted:
        for name, sh in (("untelescoped", shard), ("telescoped", tshard)):
            params = initial_params(c["cfg"], dev)
            state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=sizes["lr"]),
                               c["norm"], 0)
            step = make_spmd_derivative_step(mesh, c["cfg"], c["spec"], (0.0,), norm_steps=0)
            step(state, sh, np.array([[0]]), 0)  # warm
            torch.distributed.barrier()
            res[f"{name}_profile"] = profile_training(
                lambda: step(state, sh, np.array([[1], [2]]), 0), 2)

    # (c) the cloth family
    t0 = time.perf_counter()
    kw = dict(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN, seed=0,
              world_capacity=cloth["capacity"])
    with StepLosses(api_cloth, "make_sharded_cloth_trainer") as losses:
        reset_counts()
        train_network(0.0, lambda ps: torch.optim.Adam(ps, lr=sizes["lr"]), cloth["ds"],
                      os.path.join(workdir, "pt_cloth_cp_gp"), device=dev, graph_parallel=2,
                      steps=sizes["cloth_steps"], norm_steps=1, checkpoint=10 ** 6,
                      training_strategy=DerivativeTraining(random=False),
                      metrics=MetricsLogger(quiet=True), **kw)
        sync(dev)
    res["cloth_losses"], res["cloth_launches"] = list(losses), read_counts()
    parts["cloth_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctest = load_dataset(cloth["ds"], is_training=False)
    ccfg, cspec = api_cloth.cloth_config(ctest.meta, Args(**kw))
    part = api_cloth.ClothPlanner(ctest, Args(**kw), cspec, mesh.graph_comm, dev).get(0)
    mask_full = C._mask_full(part.shard, mesh.graph_comm)
    world = []
    with torch.no_grad():
        for t in range(part.world_pos.shape[0]):
            wp_full, _ = C._frame_features(part.shard, part.world_pos[t], mesh.graph_comm)
            (ws, wr, wm), _ = C._world(part.shard, part.world_pos[t], wp_full, mask_full, ccfg,
                                       ccfg.world_capacity, mesh.graph_comm)
            world.append((ws[wm].long().cpu().numpy(),
                          (wr[wm].long() + rank * part.pt.part_nodes).cpu().numpy()))
    res["cloth_world"] = world
    strainer = C.make_sharded_cloth_trainer(mesh.graph_comm, dataclasses.replace(
        ccfg, noise_stddev=0.0, norm_steps=0), ccfg.world_capacity)
    res["cloth_grads"] = cloth_step_grads(
        lambda st, perm, gen: strainer(st, part.shard, part.world_pos, part.times, perm, gen),
        ccfg, dev)
    res["cloth_perm"] = (part.pt.perm, part.pt.node_mask.sum(1), part.pt.part_nodes,
                         len(ctest.trajectory(0).mesh_pos))
    reset_counts()
    elog = MetricsLogger(quiet=True)
    eval_network(cloth["ds"], cloth["cp"], os.path.join(workdir, "pt_cloth_eval_gp"),
                 num_rollouts=1, device=dev, graph_parallel=2, metrics=elog, use_valid=False,
                 **kw)
    sync(dev)
    res["cloth_eval_launches"] = read_counts()
    if rank == 0:
        path = [r["path"] for r in elog.records if r["kind"] == "export"][-1]
        res["cloth_eval_pred"] = read_export(path)["prediction"]
    parts["cloth_eval_s"] = time.perf_counter() - t0
    if counted:
        params = init_cloth_params(ccfg.model, dev)
        state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=sizes["lr"]),
                           make_cloth_norm_state(ccfg).to(dev), 0)
        trainer = C.make_sharded_cloth_trainer(mesh.graph_comm, dataclasses.replace(
            ccfg, noise_stddev=0.0, norm_steps=0), ccfg.world_capacity)
        gen = torch.Generator(device=dev).manual_seed(0)
        trainer(state, part.shard, part.world_pos, part.times, [1], gen)  # warm
        torch.distributed.barrier()
        res["cloth_profile"] = profile_training(
            lambda: trainer(state, part.shard, part.world_pos, part.times, [2, 3], gen), 2)
        clear_stats(mesh)
        trainer(state, part.shard, part.world_pos, part.times, [4], gen)
        sync(dev)
        res["cloth_exchange"] = comm_stats(mesh)
    res["seconds"], res["rank_s"] = parts, time.perf_counter() - t_rank
    return res


def parallel_part_nodes(c: dict, parts: int) -> int:
    """The padded rows of each of ``parts`` parts of phase_parallel's train
    trajectory (api_spmd.GraphPlanner's partition)."""
    from mgn_tpu_torch.core.graph import cells_to_edges
    from mgn_tpu_torch.data.meta import node_type_range
    from mgn_tpu_torch.parallel.partition import partition_template

    tr = c["train"]
    s, r = cells_to_edges(tr.cells)
    tmin, tmax = node_type_range(c["meta"])
    return partition_template(tr.mesh_pos, tr.node_type, s, r, parts, type_min=tmin,
                              type_max=tmax).part_nodes


def cloth_step_grads(run, ccfg, dev) -> list:
    """``run(state, perm, generator)``, one cloth trainer window, over frame
    1 from the seed-0 parameters and fresh normalizers (SGD; ``ccfg`` with
    no warm-up): the gradient it leaves in the leaves' .grad, on the host."""
    from mgn_tpu_torch.train.cloth import make_cloth_norm_state

    params = init_cloth_params(ccfg.model, dev)
    state = TrainState(params, torch.optim.SGD(param_leaves(params), lr=1.0),
                       make_cloth_norm_state(ccfg).to(dev), 0)
    run(state, [1], torch.Generator(device=dev).manual_seed(0))
    return [p.grad.detach().cpu() for p in param_leaves(params)]


def init_cloth_params(mcfg, device):
    from mgn_tpu_torch.models.mgn_multi import init_mgn_multi

    params = init_mgn_multi(mcfg, torch.Generator().manual_seed(0), device=device)
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params


def cloth_pairs(res: dict, frame: int) -> set:
    """A rank's world edges of one frame as pairs of the dataset's node ids."""
    perm, counts, n_p, n = res["cloth_perm"]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    pos = perm[:n]
    part = np.searchsorted(offsets, pos, side="right") - 1
    orig = np.full(len(counts) * n_p, -1)
    orig[part * n_p + (pos - offsets[part])] = np.arange(n)
    s, r = res["cloth_world"][frame]
    return set(zip(orig[s].tolist(), orig[r].tolist()))


def within_radius_pairs(wp: np.ndarray, radius: float) -> int:
    """The most ordered pairs of distinct nodes closer than ``radius`` over
    the frames of ``wp`` (T, N, 3), counted on the host."""
    from mgn_tpu_torch.core.graph import within_radius, world_centre

    most = 0
    for frame in torch.as_tensor(wp):
        mask = torch.ones(frame.shape[0], dtype=torch.bool)
        hit = within_radius(frame, frame, world_centre(frame, mask), radius)
        most = max(most, int(hit.sum()) - frame.shape[0])
    return most


def phase_parallel_train(workdir: str, device: str = "cuda", sizes: dict = PARALLEL_TRAIN,
                         nccl: str = "nccl") -> dict:
    """A7b's training paths on the card, after every other phase, on
    phase_parallel's dataset and checkpoint: graph-parallel solver training
    (train_network with SolverTraining, one step of each strategy), the
    telescoped deep stages (simulate and one frame's gradient) and the
    sharded cloth family (train_network, world edges, eval_network), at mesh
    (1, 2) over gloo on the one card and, for one Euler solver step, mesh
    (1, 1) over NCCL; each held against the single-device path run here
    first."""
    import mgn_tpu_torch.api_cloth as api_cloth
    from mgn_tpu_torch import DerivativeTraining
    from mgn_tpu_torch.api import eval_network
    from mgn_tpu_torch.data.synthetic import write_flag_tfrecord_dataset
    from mgn_tpu_torch.parallel.mesh import spawn
    from mgn_tpu_torch.train.cloth import make_cloth_norm_state, make_cloth_trainer
    from mgn_tpu_torch.train.solver import SolverTrainerConfig, make_solver_trainer

    log("phase parallel train")
    dev = torch.device(device)
    rank_device = "cuda:0" if device == "cuda" else device
    counted = dev.type == "cuda"
    t_phase = t0 = time.perf_counter()
    parts, res = {}, {}
    c = parallel_setup(workdir, dev)
    model = parallel_model()
    strategies = solver_strategies(c["meta"], sizes)
    api = sys.modules["mgn_tpu_torch.api"]

    # the single-device references on the card
    with StepLosses(api, "make_solver_trainer") as ref_solver:
        reset_counts()
        train_network(0.0, lambda ps: torch.optim.Adam(ps, lr=sizes["lr"]), c["ds"],
                      os.path.join(workdir, "pt_solver_cp"), device=dev,
                      steps=sizes["solver_steps"], norm_steps=0, checkpoint=10 ** 6,
                      training_strategy=strategies["euler"], metrics=MetricsLogger(quiet=True),
                      **model)
        sync(dev)
    solver_ref_launches = read_counts()
    prep = prepare_trajectory(c["train"], c["meta"], c["spec"], device=dev)
    # the sharded bounded Tsit5's error norm divides by every part's padded rows (P * N_p, as
    # the JAX package's axis_name norm does), so its single-device reference is bucketed to
    # that count: the same norm, the same step sizes
    gp_rows = 2 * parallel_part_nodes(c, 2)
    preps = dict(tsit5=prepare_trajectory(c["train"], c["meta"], c["spec"], node_bucket=gp_rows,
                                          device=dev))
    ref_steps = {}
    for name, strategy in strategies.items():
        with BoundedTries() as tries:
            loss, grads = solver_step_grads(strategy, c["cfg"], c["spec"],
                                            initial_params(c["cfg"], dev), fresh_norm(c, dev),
                                            preps.get(name, prep), dev)
        ref_steps[name] = dict(loss=loss, grads=[g.cpu() for g in grads], tries=tries)
    if counted:  # the single-device Euler solver step's device time at this mesh
        step = make_solver_trainer(SolverTrainerConfig(c["cfg"], c["spec"], strategies["euler"],
                                                       norm_steps=0))
        params = initial_params(c["cfg"], dev)
        state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=sizes["lr"]),
                           fresh_norm(c, dev), 0)
        step(state, prep.template, prep.fields, prep.times)  # warm
        res["single_solver_profile"] = profile_training(
            lambda: [step(state, prep.template, prep.fields, prep.times)
                     for _ in range(sizes["profile_steps"])], sizes["profile_steps"])
    test = c["test"]
    ref_sim = simulate(c["ds"], os.path.join(workdir, "parallel_cp"), test.mesh_pos,
                       test.node_type, {"velocity": test.fields["velocity"][0]},
                       test.times[:sizes["serve_steps"] + 1], cells=test.cells, solver="euler",
                       device=dev, use_valid=False, **model)
    _, ref_grads = frame_loss_grads(initial_params(c["cfg"], dev), c["norm"], prep, 0,
                                    c["cfg"], c["spec"])
    ref_grads = [g.cpu() for g in ref_grads]
    # the cloth family: a 12-frame flag, its world capacity above its most within-radius
    # pairs, trained and evaluated on one device
    flag_ds, flag_cp = os.path.join(workdir, "pt_flag_ds"), os.path.join(workdir, "pt_cloth_cp")
    write_flag_tfrecord_dataset(flag_ds, nx=sizes["flag"][0], ny=sizes["flag"][1],
                                tl=sizes["flag_tl"], n_train=1, n_valid=1, n_test=1)
    fdata = load_dataset(flag_ds)
    radius = float(fdata.meta["world_edges"]["radius"])
    pairs = max(within_radius_pairs(fdata.trajectory(0).fields["world_pos"], radius),
                within_radius_pairs(load_dataset(flag_ds, is_training=False).trajectory(0)
                                    .fields["world_pos"], radius))
    capacity = -(-(pairs + 1) // 128) * 128
    ckw = dict(mps=MPS, layer_size=LATENT, hidden_layers=HIDDEN, seed=0,
               world_capacity=capacity)
    with StepLosses(api_cloth, "make_cloth_trainer") as ref_cloth:
        reset_counts()
        train_network(0.0, lambda ps: torch.optim.Adam(ps, lr=sizes["lr"]), flag_ds, flag_cp,
                      device=dev, steps=sizes["cloth_steps"], norm_steps=1, checkpoint=10 ** 6,
                      training_strategy=DerivativeTraining(random=False),
                      metrics=MetricsLogger(quiet=True), **ckw)
        sync(dev)
    cloth_ref_launches = read_counts()
    elog = MetricsLogger(quiet=True)
    eval_network(flag_ds, flag_cp, os.path.join(workdir, "pt_cloth_eval"), num_rollouts=1,
                 device=dev, metrics=elog, use_valid=False, **ckw)
    ref_eval = read_export([r["path"] for r in elog.records if r["kind"] == "export"][-1])
    ftest = load_dataset(flag_ds, is_training=False).trajectory(0)
    ftmpl = build_template(ftest.mesh_pos, ftest.node_type, cells=ftest.cells)
    ref_world = world_edge_sets(ftest.fields["world_pos"], ftmpl, capacity, dev)
    ccfg, cspec = api_cloth.cloth_config(fdata.meta, Args(**ckw))
    ccfg = dataclasses.replace(ccfg, noise_stddev=0.0, norm_steps=0)
    tprep = prepare_trajectory(ftest, fdata.meta, cspec, device=dev)
    trainer = make_cloth_trainer(ccfg)
    cloth_ref_grads = cloth_step_grads(
        lambda st, perm, gen: trainer(st, tprep.template, tprep.fields[cspec.target_fields[0]],
                                      tprep.times, perm, gen), ccfg, dev)
    if counted:  # the single-device cloth step's device time at this flag and capacity
        fprep = prepare_trajectory(fdata.trajectory(0), fdata.meta, cspec, device=dev)
        params = init_cloth_params(ccfg.model, dev)
        state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=sizes["lr"]),
                           make_cloth_norm_state(ccfg).to(dev), 0)
        wp = fprep.fields[cspec.target_fields[0]]
        gen = torch.Generator(device=dev).manual_seed(0)
        trainer(state, fprep.template, wp, fprep.times, [1], gen)  # warm
        res["single_cloth_profile"] = profile_training(
            lambda: trainer(state, fprep.template, wp, fprep.times, [2, 3], gen), 2)
    n_flag = len(ftest.mesh_pos)
    sync(dev)
    parts["single_device_s"] = time.perf_counter() - t0
    log(f"  single-device references on the card in {parts['single_device_s']:.2f} s: solver "
        f"train_network losses {[round(x, 6) for x in ref_solver]}; steps "
        + ", ".join(f"{k} {v['loss']:.6f}" for k, v in ref_steps.items())
        + f" (bounded Tsit5 tries {ref_steps['tsit5']['tries']}, its reference bucketed to "
        f"the parts' {gp_rows} rows); flag {sizes['flag']} x "
        f"{sizes['flag_tl']} frames: at most {pairs} ordered pairs within radius {radius} "
        f"over its train and test frames (counted on the host), world capacity {capacity}; "
        f"cloth losses {[round(x, 6) for x in ref_cloth]}")

    # mesh (1, 1), one rank over NCCL: one Euler solver step
    t0 = time.perf_counter()
    (one,) = spawn(1, parallel_train_nccl_rank, (workdir, rank_device, nccl, sizes),
                   backend=nccl)
    parts["nccl_s"] = time.perf_counter() - t0
    ref = ref_steps["euler"]
    loss_bits = one["loss"] == ref["loss"]
    log(f"  mesh (1, 1), {nccl}: one sharded Euler solver step in {one['seconds']:.2f} s: loss "
        f"{one['loss']!r} against the single device's {ref['loss']!r} (the same bits "
        f"{loss_bits}); launches {one['launches']}")
    nccl_grads = check_grads("mesh (1, 1) solver step's gradient against the single device's",
                             torch.float32, one["grads"], ref["grads"])
    if not loss_bits or (counted and any(one["launches"][k] <= 0 for k in FAMILY_TRAIN)):
        raise AssertionError(f"mesh (1, 1) solver step: loss {one['loss']!r} against "
                             f"{ref['loss']!r}, launches {one['launches']}")

    # mesh (1, 2), two ranks over gloo sharing the card
    t0 = time.perf_counter()
    cloth = dict(ds=flag_ds, cp=flag_cp, capacity=capacity)
    ranks = spawn(2, parallel_train_rank, (workdir, rank_device, sizes, cloth), backend="gloo")
    parts["gloo_s"] = time.perf_counter() - t0
    r0 = ranks[0]

    # (a) the solver path
    if [r["solver_part_nodes"] for r in ranks] != [gp_rows // 2] * 2:
        raise AssertionError(f"the ranks' parts hold {[r['solver_part_nodes'] for r in ranks]} "
                             f"rows, the Tsit5 reference was bucketed for {gp_rows // 2}")
    losses = [r["solver_losses"] for r in ranks]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], ref_solver)]
    log(f"  (a) train_network(graph_parallel=2, SolverTraining Euler over {sizes['saves']} save "
        f"intervals, remat): losses {[round(x, 6) for x in losses[0]]} against single-device "
        f"{[round(x, 6) for x in ref_solver]} (worst relative {max(rel):.2e}, tolerance "
        f"{PARALLEL_LOSS_RTOL}); the ranks' losses the same {losses[0] == losses[1]}")
    if not (len(losses[0]) == len(ref_solver) == sizes["solver_steps"]
            and losses[0] == losses[1] and max(rel) <= PARALLEL_LOSS_RTOL):
        raise AssertionError(f"graph-parallel solver train_network: {losses} against {ref_solver}")
    solver = dict(losses=losses[0], ref_losses=ref_solver, worst_rel=max(rel), steps={})
    for name in strategies:
        got = [r["solver_steps"][name] for r in ranks]
        step_rel = abs(got[0]["loss"] - ref_steps[name]["loss"]) / abs(ref_steps[name]["loss"])
        tries = [g["tries"] for g in got]
        log(f"  (a) one {name} step: loss {got[0]['loss']:.6f} against "
            f"{ref_steps[name]['loss']:.6f} (relative {step_rel:.2e}), the ranks the same "
            f"{got[0]['loss'] == got[1]['loss']}"
            + (f"; bounded Tsit5 tries by rank {tries}, single device "
               f"{ref_steps[name]['tries']}" if name == "tsit5" else ""))
        g = check_grads(f"(a) {name} step's gradient, graph_parallel=2 vs single device",
                        torch.float32, got[0]["grads"], ref_steps[name]["grads"])
        if not (step_rel <= PARALLEL_LOSS_RTOL and got[0]["loss"] == got[1]["loss"]
                and tries[0] == tries[1] == ref_steps[name]["tries"]):
            raise AssertionError(f"graph-parallel {name} step: {step_rel:.2e}, tries {tries} "
                                 f"against {ref_steps[name]['tries']}")
        solver["steps"][name] = dict(loss=got[0]["loss"], ref=ref_steps[name]["loss"],
                                     rel=step_rel, tries=tries[0], grads=g)

    # (b) the telescoped stages
    tel = {}
    for r in ranks:
        err_ref = float(np.abs(r["simulate_telescope"] - ref_sim).max())
        err_deep = float(np.abs(r["simulate_telescope"] - r["simulate_deep"]).max())
        tel.setdefault("max_abs_err", []).append(err_ref)
        tel.setdefault("max_abs_err_untelescoped", []).append(err_deep)
    rows = r0["telescope_rows"]
    log(f"  (b) simulate(graph_parallel=2, telescope_stages={sizes['telescope']}), "
        f"{sizes['serve_steps']} Euler steps: max |du| against simulate "
        f"{max(tel['max_abs_err']):.3e}, against the untelescoped deep plan "
        f"{max(tel['max_abs_err_untelescoped']):.3e} "
        f"(tolerance {PARALLEL_ROLLOUT_TOL}); rank 0's part {rows['part_nodes']} rows, extended "
        f"table (node rows, edge rows) {rows['ext']}, stages (rounds, node rows, edge rows) "
        f"{rows['stages']}")
    tel_grads = check_grads("(b) one frame's gradient through the telescoped stages vs single "
                            "device", torch.float32, r0["telescope_grads"], ref_grads)
    if not (max(tel["max_abs_err"]) <= PARALLEL_ROLLOUT_TOL
            and max(tel["max_abs_err_untelescoped"]) <= PARALLEL_ROLLOUT_TOL):
        raise AssertionError(f"telescoped simulate: {tel}")
    tel.update(rows=rows, grads=tel_grads)

    # (c) the cloth family
    losses = [r["cloth_losses"] for r in ranks]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], ref_cloth)]
    union_same = all(cloth_pairs(ranks[0], f) | cloth_pairs(ranks[1], f)
                     == {divmod(int(k), ftmpl.num_nodes) for k in ref_world[f]}
                     for f in range(len(ref_world)))
    eval_err = float(np.abs(r0["cloth_eval_pred"] - ref_eval["prediction"]).max())
    log(f"  (c) cloth train_network(graph_parallel=2), {sizes['cloth_steps']} noise-free steps: "
        f"losses {[round(x, 6) for x in losses[0]]} against single-device "
        f"{[round(x, 6) for x in ref_cloth]} (worst relative {max(rel):.2e}); the parts' world "
        f"edges of each of {len(ref_world)} test frames together the single-device set "
        f"{union_same} (live edges {[len(s) for s in ref_world]}); eval_network(graph_parallel=2)"
        f" over {sizes['flag_tl'] - 2} rollout steps: max |dx| against the single device "
        f"{eval_err:.3e} (tolerance {PARALLEL_ROLLOUT_TOL}) for {n_flag} nodes")
    if not (len(losses[0]) == len(ref_cloth) and losses[0] == losses[1]
            and max(rel) <= PARALLEL_LOSS_RTOL and union_same
            and eval_err <= PARALLEL_ROLLOUT_TOL):
        raise AssertionError(f"graph-parallel cloth: losses {losses} against {ref_cloth}, union "
                             f"{union_same}, eval {eval_err:.3e}")
    cloth_grads = check_grads("(c) one cloth step's gradient, summed over graph_parallel=2 vs "
                              "single device", torch.float32, r0["cloth_grads"], cloth_ref_grads)
    if not all(torch.equal(a, b) for a, b in zip(r0["cloth_grads"], ranks[1]["cloth_grads"])):
        raise AssertionError("the ranks' summed cloth gradients differ")
    cloth_res = dict(losses=losses[0], ref_losses=ref_cloth, worst_rel=max(rel), capacity=capacity,
                     pairs=pairs, union_same=union_same, eval_max_abs_err=eval_err,
                     grads=cloth_grads)

    # launches: every kernel the single-device path launches, the sharded path launches too
    for name, got, want in (("solver", "solver_launches", solver_ref_launches),
                            ("cloth", "cloth_launches", cloth_ref_launches),
                            ("telescope", "telescope_launches", solver_ref_launches)):
        for r in ranks:
            missing = [k for k, v in want.items() if v > 0 and k in FAMILY_TRAIN + FORWARD
                       and r[got][k] <= 0]
            if counted and missing:
                raise AssertionError(f"rank {r['rank']}: the {name} path launched no {missing}")
    if counted:
        log(f"  single device: Euler solver step busy "
            f"{res['single_solver_profile']['device_busy_ms_per_step']:.3f} ms (idle share "
            f"{res['single_solver_profile']['idle_share']:.4f}), cloth step busy "
            f"{res['single_cloth_profile']['device_busy_ms_per_step']:.3f} ms (idle share "
            f"{res['single_cloth_profile']['idle_share']:.4f})")
    for r in ranks:
        if "solver_profile" not in r:
            continue
        for path in ("solver", "untelescoped", "telescoped", "cloth"):
            prof = r[f"{path}_profile"]
            if prof.get("device_busy_ms_per_step") is None:
                raise AssertionError(f"rank {r['rank']}: the {path} step's profile is empty")
        ex = {p: r[f"{p}_exchange"] for p in ("solver", "cloth")}
        log(f"  rank {r['rank']}: device busy ms a step (idle share): solver "
            + ", ".join(f"{p} {r[p + '_profile']['device_busy_ms_per_step']:.3f} "
                        f"({r[p + '_profile']['idle_share']:.4f})"
                        for p in ("solver", "untelescoped", "telescoped", "cloth"))
            + "; launches a path "
            + json.dumps({p: r[p + "_launches"] for p in ("solver", "telescope", "cloth")})
            + f"; collectives a step (calls, bytes, host ms) {json.dumps(ex)}; seconds "
            f"{json.dumps({k: round(v, 2) for k, v in r['seconds'].items()})}, "
            f"{r['rank_s']:.2f} s in all")
    res.update(nccl=dict(loss_bits=loss_bits, grads=nccl_grads, launches=one["launches"]),
               solver=solver, telescope=tel, cloth=cloth_res,
               ranks=[{k: r.get(k) for k in ("solver_profile", "untelescoped_profile",
                                             "telescoped_profile", "cloth_profile",
                                             "solver_exchange", "cloth_exchange",
                                             "solver_launches", "telescope_launches",
                                             "cloth_launches", "cloth_eval_launches",
                                             "telescope_rows", "seconds", "rank_s")}
                      for r in ranks])
    parts["phase_s"] = time.perf_counter() - t_phase
    res["seconds"] = parts
    log(f"  phase parallel train: {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    return res


# --- phase artefacts: the adaptive artefact, the sharded artefacts, the multihost twin ------

# after phase_parallel_train, on phase_serving's cylinder and phase_parallel's dataset and
# checkpoint: the adaptive artefact over 5 save intervals of the cylinder; the sharded ones
# over 5 Euler steps (deep, classic) and 3 adaptive save intervals (deep) of the 5,233-node
# test trajectory; the multihost twin's first window (up to 32 frames) at full width
ARTEFACTS = dict(adaptive_saves=5, sharded_steps=5, sharded_saves=3, twin_window=32)
ARTEFACT_TOL = 1e-5  # the adaptive artefact against eager simulate on the card: max |du|
# the sharded artefact's cells: (label, solver, Args fields, save intervals key)
SHARDED = (("deep euler", "euler", {}, "sharded_steps"),
           ("classic euler", "euler", {"halo_rounds": 0}, "sharded_steps"),
           ("deep tsit5_adaptive", "tsit5_adaptive", {}, "sharded_saves"))
# two meshes (1, 2) over gloo at once, each exporting its cells in turn (an export is
# host work): the deep cells on one, the classic cell and the multihost twin on the other
SHARDED_GROUPS = (("deep euler", "deep tsit5_adaptive"), ("classic euler", "twin"))


def artefact_census(blob: bytes) -> dict:
    """An artefact's graph across its modules (a while_loop's bodies too):
    the serving operators, while_loops and functional collectives, the
    call count and the node count."""
    import io

    program = torch.export.load(io.BytesIO(blob))
    calls, nodes = {}, 0
    for module in program.graph_module.modules():
        for node in module.graph.nodes:
            nodes += 1
            if node.op == "call_function":
                calls[str(node.target)] = calls.get(str(node.target), 0) + 1
    return dict(operators={k.split(".")[1]: v for k, v in calls.items()
                           if k.startswith("mgn_tpu_torch.")},
                while_loops=calls.get("while_loop", 0),
                collectives={k.split(".")[1]: v for k, v in calls.items()
                             if k.startswith("_c10d_functional.")},
                nodes=nodes, calls=sum(calls.values()))


def sharded_program(blob: bytes, rank: int) -> bytes:
    """Rank ``rank``'s program in a sharded artefact's bytes."""
    import io
    import zipfile

    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return z.read(f"rank{rank}.pt2")


def artefact_kernels(fn) -> dict:
    """The forward's device kernels the guarded profiler saw in one ``fn()``."""
    counts = kernel_counts(fn)
    return {k: sum(n for name, n in counts.items() if FORWARD_KERNELS[k] in name)
            for k in FORWARD}


def artefact_adaptive(call, sizes: dict = ARTEFACTS, device: str = "cuda") -> dict:
    """export_simulator(solver="tsit5_adaptive") of phase_serving's cylinder
    over sizes['adaptive_saves'] save intervals, exported on the card and
    loaded, against eager simulate(solver="tsit5_adaptive"): the same tries
    per interval, max |du| <= ARTEFACT_TOL, 7 forwards a try by the counters
    and the profiler; the graph's operators (the while_loop bodies' too),
    export and load seconds, bytes."""
    from mgn_tpu_torch.serve import export_simulator, load_simulator

    n = sizes["adaptive_saves"]
    times, v0 = call["times"][:n + 1], call["initial_fields"]["velocity"]
    export_call = {k: v for k, v in call.items() if k not in ("initial_fields", "times")}
    t0 = time.perf_counter()
    blob = export_simulator(num_steps=len(times), solver="tsit5_adaptive", device=device,
                            **export_call)
    export_s = time.perf_counter() - t0
    census = artefact_census(blob)
    t0 = time.perf_counter()
    sim = load_simulator(blob, device=device)
    load_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    got = sim(times, v0)
    first_s = time.perf_counter() - t0
    launches = {k: read_counts()[k] for k in FORWARD}
    tries = sim.stats
    t0 = time.perf_counter()
    sim(times, v0)
    call_s = time.perf_counter() - t0
    with AdaptiveStats() as calls:
        t0 = time.perf_counter()
        ref = simulate(**dict(call, times=times, solver="tsit5_adaptive", device=device))
        eager_s = time.perf_counter() - t0
    eager_tries = calls[0]["tries"]
    err = float(np.abs(got - ref).max())
    n_tries = sum(a + r for a, r in tries)
    profile = (artefact_kernels(lambda: sim(times, v0)) if device == "cuda" else None)
    res = dict(export_s=export_s, bytes=len(blob), graph=census, load_s=load_s,
               first_call_s=first_s, call_s=call_s, eager_s=eager_s, tries=tries,
               eager_tries=eager_tries, max_abs_err=err,
               same_bits=bool(np.array_equal(got, ref)), launches=launches,
               device_kernels=profile)
    log(f"  adaptive artefact (cylinder, {n} save intervals): exported in {export_s:.2f} s, "
        f"{len(blob)} bytes, graph {census}; loaded in {load_s:.2f} s; tries {tries} against "
        f"eager simulate's {eager_tries}; max |du| {err:.3e} (tolerance {ARTEFACT_TOL}), the "
        f"same bits {res['same_bits']}; first call {first_s:.3f} s, then {call_s:.3f} s "
        f"(eager simulate {eager_s:.3f} s); launches {launches}, profiler {profile}")
    want = {k: (7 * n_tries if k == "weight_streams" else 7 * n_tries * MPS) for k in FORWARD}
    counted = device == "cuda"  # the counters count kernel launches (none in a CPU rehearsal)
    if not (tries == eager_tries and err <= ARTEFACT_TOL and np.isfinite(got).all()
            and census["while_loops"] == 2 and (not counted or launches == want == profile)):
        raise AssertionError(f"the adaptive artefact: {res}, expected launches {want}")
    return res


def artefact_rank(rank: int, workdir: str, device: str, sizes: dict, group: tuple) -> dict:
    """One rank of mesh (1, 2) over gloo, both ranks on ``device``: each
    SHARDED cell of ``group`` exported (export_sharded_simulator), loaded
    and run on the test trajectory beside simulate(graph_parallel=2),
    seconds, bytes and launches by the counters (the deep Euler artefact's
    by the profiler too); where ``group`` names it, the multihost twin's
    first window at full width."""
    from mgn_tpu_torch.examples import multihost_cylinder as twin
    from mgn_tpu_torch.serve import export_sharded_simulator, load_sharded_simulator

    dev = torch.device(device)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # two ranks share the host
    t_rank = time.perf_counter()
    ds, cp = os.path.join(workdir, "parallel_ds"), os.path.join(workdir, "parallel_cp")
    test, model = load_dataset(ds, is_training=False).trajectory(0), parallel_model()
    v0, res = test.fields["velocity"][0], {"rank": rank}
    for label, solver, kw, key in SHARDED:
        if label not in group:
            continue
        times = test.times[:sizes[key] + 1]
        t0 = time.perf_counter()
        blob = export_sharded_simulator(ds, cp, test.mesh_pos, test.node_type,
                                        num_steps=len(times), cells=test.cells, solver=solver,
                                        graph_parallel=2, device=dev, use_valid=False,
                                        **model, **kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sim = load_sharded_simulator(blob, device=dev)
        load_s = time.perf_counter() - t0
        reset_counts()
        pred = sim(times, v0)
        sync(dev)
        launches = {k: read_counts()[k] for k in FORWARD}
        t0 = time.perf_counter()
        sim(times, v0)
        sync(dev)
        call_s = time.perf_counter() - t0
        with AdaptiveStats() as calls:
            ref = simulate(ds, cp, test.mesh_pos, test.node_type, {"velocity": v0}, times,
                           cells=test.cells, solver=solver, device=dev, graph_parallel=2,
                           use_valid=False, **model, **kw)
        cell = dict(pred=pred, ref=ref, tries=sim.stats,
                    eager_tries=calls[0]["tries"] if calls else [], export_s=export_s,
                    load_s=load_s, call_s=call_s, bytes=len(blob), launches=launches)
        if rank == 0:
            cell["graph"] = artefact_census(sharded_program(blob, 0))
        if label == "deep euler" and dev.type == "cuda":
            cell["device_kernels"] = artefact_kernels(lambda: sim(times, v0))
        res[label] = cell
        log(f"  rank {rank}, {label}: exported in {export_s:.2f} s, loaded in {load_s:.2f} s "
            f"[{time.perf_counter() - t_rank:.1f} s into the rank]")
    if "twin" in group:
        t0 = time.perf_counter()
        twin.WINDOW = twin.FRAMES = sizes["twin_window"]
        _, history = twin.main([ds, "2", "--dist-backend", "gloo", "--device", dev.type])
        res["twin"] = dict(losses=history[0].tolist(), seconds=time.perf_counter() - t0)
    res["rank_s"] = time.perf_counter() - t_rank
    return res


def artefact_nccl_rank(rank: int, workdir: str, device: str, sizes: dict) -> dict:
    """Mesh (1, 1) over NCCL: the deep Euler artefact exported, loaded and
    run once (the functional collectives on NCCL)."""
    from mgn_tpu_torch.serve import export_sharded_simulator, load_sharded_simulator

    ds, cp = os.path.join(workdir, "parallel_ds"), os.path.join(workdir, "parallel_cp")
    test = load_dataset(ds, is_training=False).trajectory(0)
    times = test.times[:sizes["sharded_steps"] + 1]
    t0 = time.perf_counter()
    blob = export_sharded_simulator(ds, cp, test.mesh_pos, test.node_type, num_steps=len(times),
                                    cells=test.cells, graph_parallel=1, device=device,
                                    use_valid=False, **parallel_model())
    export_s = time.perf_counter() - t0
    reset_counts()
    pred = load_sharded_simulator(blob, device=device)(times, test.fields["velocity"][0])
    return dict(pred=pred, export_s=export_s, bytes=len(blob),
                launches={k: read_counts()[k] for k in FORWARD},
                graph=artefact_census(sharded_program(blob, 0)))


def phase_artefacts(workdir: str, call, device: str = "cuda", sizes: dict = ARTEFACTS,
                    nccl: str = "nccl") -> dict:
    """The adaptive and the sharded serving artefacts and the multihost
    twin, after every other phase: :func:`artefact_adaptive` here; two
    meshes (1, 2) over gloo (:func:`artefact_rank`, SHARDED_GROUPS: each
    sharded artefact against simulate(graph_parallel=2) and against
    single-device simulate, max |du| <= 1e-3, the ranks' results the same;
    the twin's losses finite and the same on both ranks); mesh (1, 1) over
    NCCL (:func:`artefact_nccl_rank`).  The meshes run in threads beside
    the single-device export: exports are host work."""
    from mgn_tpu_torch.parallel.mesh import spawn

    log("phase artefacts")
    rank_device = "cuda:0" if device == "cuda" else device
    t_phase = time.perf_counter()
    parts, res = {}, {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        return fn(*args, **kwargs), time.perf_counter() - t0

    # the exports are host work: the ranks' (two meshes over gloo, one over NCCL) overlap
    # the single-device artefact's and the references here
    with concurrent.futures.ThreadPoolExecutor(len(SHARDED_GROUPS) + 1) as pool:
        gloo = [pool.submit(timed, spawn, 2, artefact_rank,
                            (workdir, rank_device, sizes, group), backend="gloo")
                for group in SHARDED_GROUPS]
        nccl_job = pool.submit(timed, spawn, 1, artefact_nccl_rank,
                               (workdir, rank_device, sizes), backend=nccl)
        res["adaptive"], parts["adaptive_s"] = timed(artefact_adaptive, call, sizes, device)
        t0 = time.perf_counter()
        ds, cp = os.path.join(workdir, "parallel_ds"), os.path.join(workdir, "parallel_cp")
        test, model = load_dataset(ds, is_training=False).trajectory(0), parallel_model()
        v0 = test.fields["velocity"][0]
        single = {}
        for label, solver, kw, key in SHARDED:
            single[label] = simulate(ds, cp, test.mesh_pos, test.node_type, {"velocity": v0},
                                     test.times[:sizes[key] + 1], cells=test.cells,
                                     solver=solver, device=device, use_valid=False, **model)
        parts["single_device_s"] = time.perf_counter() - t0
        meshes = [job.result() for job in gloo]
        (one,), parts["nccl_s"] = nccl_job.result()
    parts["gloo_s"] = [secs for _, secs in meshes]
    res["rank_s"] = [[r["rank_s"] for r in ranks] for ranks, _ in meshes]
    ranks = [{k: v for ranks, _ in meshes for k, v in ranks[r].items()} for r in range(2)]
    counted = device == "cuda"  # the counters count kernel launches (none in a CPU rehearsal)
    res["sharded"] = {}
    for label, solver, kw, key in SHARDED:
        cells = [r[label] for r in ranks]
        same = bool(np.array_equal(cells[0]["pred"], cells[1]["pred"]))
        bits = [bool(np.array_equal(c["pred"], c["ref"])) for c in cells]
        gap = max(float(np.abs(c["pred"] - c["ref"]).max()) for c in cells)
        err = max(float(np.abs(c["pred"] - single[label]).max()) for c in cells)
        out = dict(ranks_same=same, simulate_bits=bits, simulate_gap=gap, single_err=err,
                   tries=[c["tries"] for c in cells], eager_tries=[c["eager_tries"] for c in cells],
                   export_s=[c["export_s"] for c in cells], load_s=[c["load_s"] for c in cells],
                   call_s=[c["call_s"] for c in cells], bytes=cells[0]["bytes"],
                   launches=[c["launches"] for c in cells], graph=cells[0]["graph"],
                   device_kernels=[c.get("device_kernels") for c in cells])
        res["sharded"][label] = out
        log(f"  sharded artefact, {label} ({sizes[key]} save intervals): export s by rank "
            f"{[round(x, 2) for x in out['export_s']]}, load s {[round(x, 2) for x in out['load_s']]}"
            f", call s {[round(x, 3) for x in out['call_s']]}, {out['bytes']} bytes, rank 0's graph "
            f"{out['graph']}; the ranks the same {same}; against simulate(graph_parallel=2): "
            f"the same bits {bits}, max |du| {gap:.3e}; against single-device simulate max |du| "
            f"{err:.3e} (tolerance {PARALLEL_ROLLOUT_TOL}); tries {out['tries']} (eager "
            f"{out['eager_tries']}); launches {out['launches']}, profiler {out['device_kernels']}")
        if not (same and gap <= PARALLEL_ROLLOUT_TOL and err <= PARALLEL_ROLLOUT_TOL
                and np.isfinite(cells[0]["pred"]).all()
                and out["tries"][0] == out["tries"][1] == out["eager_tries"][0]
                and (not counted or all(c["launches"][k] > 0 for c in cells for k in FORWARD))):
            raise AssertionError(f"the sharded artefact, {label}: {out}")
    twin = [r["twin"]["losses"] for r in ranks]
    res["twin"] = dict(losses=twin[0], seconds=[r["twin"]["seconds"] for r in ranks])
    log(f"  multihost twin, mesh (1, 2) over gloo, one window of {len(twin[0])} updates at full "
        f"width: losses {[round(x, 6) for x in twin[0]]}, the ranks the same {twin[0] == twin[1]}, "
        f"seconds by rank {[round(s, 2) for s in res['twin']['seconds']]}")
    if not (twin[0] == twin[1] and np.isfinite(twin[0]).all() and len(twin[0]) > 0):
        raise AssertionError(f"the multihost twin's losses {twin}")

    err = float(np.abs(one["pred"] - single["deep euler"]).max())
    res["nccl"] = dict(max_abs_err=err, export_s=one["export_s"], bytes=one["bytes"],
                       launches=one["launches"], graph=one["graph"])
    log(f"  mesh (1, 1) over {nccl}: the deep Euler artefact exported in {one['export_s']:.2f} s, "
        f"{one['bytes']} bytes, collectives {one['graph']['collectives']}; against single-device "
        f"simulate max |du| {err:.3e}; launches {one['launches']}")
    if not (err <= PARALLEL_ROLLOUT_TOL and (not counted or all(
            one["launches"][k] > 0 for k in FORWARD))):
        raise AssertionError(f"the NCCL artefact: {res['nccl']}")
    parts["phase_s"] = time.perf_counter() - t_phase
    res["seconds"] = parts
    log(f"  phase artefacts: {json.dumps(parts)}; the ranks' own seconds {res['rank_s']}")
    return res


# --- phase widths: latent widths the kernels are not built for -------------------------

WIDTHS = (90, 96, 200)  # model widths held at their padded tiles (128, 128, 256)
WIDTH_MODEL, WIDTH_CLOTH = 96, 90  # the cylinder model's and the flag's width
WIDTH_STEPS = 10  # Euler steps of the width phase's serving check
WIDTH_ROUNDS = 2  # rounds of the kernel checks' processor (round 0 is checked)


def pad_is_zero(label, t, width: int, tile: int) -> None:
    """Raise unless every padded column of ``t`` is exactly 0: the columns
    width..tile of each ``tile``-wide block of its last axis (one block, or
    two for the LayerNorm partial sums ``[sum dy xhat | sum dy]``) and, for a
    weight gradient, the rows width..tile of each ``tile``-row block."""
    x = t.detach().float()
    blocks = x.reshape(*x.shape[:-1], x.shape[-1] // tile, tile)
    bad = int((blocks[..., width:] != 0).sum())
    if x.dim() == 2 and x.shape[0] % tile == 0 and x.shape[0] <= 3 * tile:
        rows = x.reshape(x.shape[0] // tile, tile, x.shape[-1])
        bad += int((rows[:, width:] != 0).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} padded entries are not 0 (width {width}, tile "
                             f"{tile})")


def width_bounds(L: int, dtype, n_pad: int, e_pad: int) -> dict:
    """Each kernel's least time at the real width ``L`` on the cylinder's
    shapes: (bytes, operations, dtype of the peak), each input read once and
    each output written once at width L, as the full-width phases count
    them (the weight streams, of MPS rounds in the serving form: the real
    weights read, the streams written at the tile width the kernels read)."""
    b, H, tile = torch.finfo(dtype).bits // 8, HIDDEN, F.kernel_width(L)
    f32 = torch.float32
    # the weight streams in the serving form (K2's, K3's, K7's) of MPS rounds
    wb = lambda parts: (parts + H) * L * L * b + (H + 1) * L * b + 2 * L * 4
    groups = lambda rows, per: -(-rows // per) * 2 * L * 4
    k5 = lambda extra: (4 * n_pad * L * b + wb(2) + (2 * H + 1) * n_pad * L * b + n_pad * L * 4
                        + groups(n_pad, F._NODE_BWD_ROWS) + (2 * n_pad * L * 4 if extra else 0))
    k4_in = (2 * e_pad * L + e_pad) * b + 3 * n_pad * L * 4 + 2 * e_pad * 4
    k3 = 2 * n_pad * L * b + n_pad * L * 4 + wb(2)
    streams = sum(F._stream_sizes(tile, dtype, H + 1, H + 1)) * b
    return {
        "edge_project": (n_pad * L * b + 2 * L * L * b + 2 * n_pad * L * 4,
                         4 * n_pad * L * L, dtype),
        "edge_round": ((3 * e_pad * L + e_pad) * b + 2 * n_pad * L * 4 + 2 * e_pad * 4 + wb(1),
                       2 * e_pad * (1 + H) * L * L, dtype),
        "csr_segment_sum": (e_pad * L * b + (n_pad + 1) * 4 + n_pad * L * 4, e_pad * L, f32),
        "csr_segment_sum_perm": (e_pad * L * b + e_pad * 4 + (n_pad + 1) * 4 + n_pad * L * 4,
                                 e_pad * L, f32),
        "node_round": (k3, 2 * n_pad * (2 + H) * L * L, dtype),
        "node_round_extra": (k3 + n_pad * L * 4, 2 * n_pad * (2 + H) * L * L, dtype),
        "weight_streams": (MPS * (5 + 2 * H) * L * L * b + MPS * streams, 0, dtype),
        "edge_round_bwd": (k4_in + wb(3) + (2 * H + 4) * e_pad * L * b
                           + groups(e_pad, F._EDGE_BWD_ROWS), 2 * (4 + 2 * H) * L * L * e_pad,
                           dtype),
        "edge_round_bwd_defer": (k4_in + wb(1) + (2 * H + 2) * e_pad * L * b
                                 + groups(e_pad, F._EDGE_BWD_ROWS),
                                 2 * (2 + 2 * H) * L * L * e_pad, dtype),
        "node_round_bwd": (k5(False), 4 * (2 + H) * L * L * n_pad, dtype),
        "node_round_bwd_extra": (k5(True), 4 * (2 + H) * L * L * n_pad, dtype),
        "first_layer_adjoint": (2 * n_pad * L * 4 + 2 * n_pad * L * b + 2 * L * L * b,
                                4 * L * L * n_pad, f32),
        "wgrad": (2 * e_pad * L * b + (L * L + L) * 4, 2 * e_pad * L * L + e_pad * L, f32),
        "wgrad_node_rows": (n_pad * L * b + 2 * n_pad * L * 4 + 2 * L * L * 4,
                            4 * n_pad * L * L, f32),
    }


def width_inputs(t, L: int, dtype, gen) -> dict:
    """A random processor of width ``L`` (WIDTH_ROUNDS rounds) padded to its
    tile as fused_process pads it, cast to ``dtype``, and the cylinder's
    inputs and cotangents at the tile width with zero padded columns."""
    tile = F.kernel_width(L)
    cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=L,
                    hidden_layers=HIDDEN, message_passing_steps=WIDTH_ROUNDS)
    proc = init_mgn(cfg, torch.Generator().manual_seed(L), device="cuda")["processor"]
    em_all, nm_all = (F.cast_mlp(F._pad_mlp(proc[m], L, tile), dtype)
                      for m in ("edge_mlp", "node_mlp"))
    ev = t.edge_mask.to(dtype)[:, None].contiguous()
    rnd = lambda rows, dt: F._pad_cols(
        torch.randn((rows, L), generator=gen, device="cuda"), tile).to(dt).contiguous()
    n_pad, e_pad = t.num_nodes, t.num_edges
    return dict(L=L, tile=tile, em_all=em_all, nm_all=nm_all, em=F.round_params(em_all, 0),
                nm=F.round_params(nm_all, 0), ev=ev, v0=rnd(n_pad, dtype),
                e0=(rnd(e_pad, dtype) * ev).contiguous(), dv=rnd(n_pad, dtype),
                de=(rnd(e_pad, dtype) * ev).contiguous(), extra=rnd(n_pad, torch.float32))


def width_kernels(t, L: int, dtype, gen) -> dict:
    """Every kernel of the processor at width ``L`` on its padded tile,
    one round at the cylinder's shapes, against its plain version at the
    same width under the rule it is held to at the built widths: the weight
    streams and K1, K1-perm (at the tile and at the real width L, where L
    mod 4 != 0 runs K1's tail form) bit for bit; K7 by K7_TOL; K2, K3 and
    K3 extra by check_tol; K5 (both forms), K4 (three-part and defer), K8
    and K6 (one grouped call per MLP round, the defer_first edge group)
    by check_bwd.  Every padded column of every output exactly 0.  Returns
    the inputs and outputs the timings reuse."""
    x = width_inputs(t, L, dtype, gen)
    tile, em, nm, ev = x["tile"], x["em"], x["nm"], x["ev"]
    zero = lambda label, *ts: [pad_is_zero(f"{label} L {L} {dtype}", a, L, tile) for a in ts]
    n_pad = t.num_nodes
    for form, (adjoint, defer) in WS_FORMS.items():
        got = F.weight_streams(x["em_all"], x["nm_all"], adjoint, defer)
        ref = F.weight_streams_plain(x["em_all"], x["nm_all"], adjoint, defer)
        torch.cuda.synchronize()
        if not all(torch.equal(as_bits(a), as_bits(b)) for a, b in zip(got, ref)):
            raise AssertionError(f"weight_streams {form} L {L} {dtype}: not the plain bits")
    ws_e, ws_n, ws_p = (s[0] for s in F.weight_streams(x["em_all"], x["nm_all"]))
    wa_e, wa_n, wa_p = (s[0] for s in F.weight_streams(x["em_all"], x["nm_all"], adjoint=True))
    wd_e = F.weight_streams(x["em_all"], adjoint=True, defer=True)[0][0]
    size_p = F._stream_sizes(tile, dtype, 0, 0)[2]
    out = dict(x, ws=(ws_e, ws_n, ws_p), wa=(wa_e, wa_n, wa_p), wd_e=wd_e, size_p=size_p)
    # K7
    p, q = F.edge_project(x["v0"], em, ws_p)
    ref = F.edge_project_plain(x["v0"], em)
    torch.cuda.synchronize()
    k7 = max(float((a - b).abs().max()) for a, b in zip((p, q), ref))
    if not k7 <= K7_TOL * max(1.0, max(float(b.abs().max()) for b in ref)):
        raise AssertionError(f"K7 L {L} {dtype}: max_abs_err {k7:.3e}")
    zero("K7 P, Q", p, q)
    # K2
    e_k = x["e0"].clone()
    msg = F.edge_round(e_k, p, q, t.senders, t.receivers, ev, em, ws_e, width=L)
    e_p, msg_p = F.edge_round_plain(x["e0"], p, q, t.senders, t.receivers, ev, em, width=L)
    torch.cuda.synchronize()
    k2 = err_stats(msg, msg_p)
    check_tol(f"K2 L {L} (msg)", dtype, *k2)
    check_tol(f"K2 L {L} (e)", dtype, *err_stats(e_k, e_p))
    zero("K2 msg, e", msg, e_k)
    # K1 and K1-perm, at the tile and at the real width: the CPU plain version's bits
    for data in (msg, msg[:, :L].contiguous()):
        hold_k1(f"L {L} F {data.shape[1]} {dtype}", data, t.receivers, t.row_offsets, n_pad)
        hold_k1(f"perm L {L} F {data.shape[1]} {dtype}", data, t.senders, t.sender_offsets,
                n_pad, t.sender_perm)
    agg = csr_segment_sum(msg, t.receivers, t.row_offsets, n_pad)
    zero("K1 agg", agg)
    out.update(p=p, q=q, msg=msg, agg=agg)
    # K3 and its extra form
    k3 = {}
    for name, extra in (("node_round", None), ("node_round_extra", x["extra"])):
        v_k = x["v0"].clone()
        F.node_round(v_k, agg, nm, ws_n, extra, width=L)
        v_p = F.node_round_plain(x["v0"], agg, nm, extra, width=L)
        torch.cuda.synchronize()
        k3[name] = err_stats(v_k, v_p)
        check_tol(f"{name} L {L} (v)", dtype, *k3[name])
        zero(name, v_k)
    # K5, both forms, on the compute-dtype aggregate (the forward's saved one)
    agg_cd = agg.to(dtype)
    k5 = {}
    for name, extra in (("node_round_bwd", None), ("node_round_bwd_extra", x["extra"])):
        dv = x["dv"].clone()
        got = F.node_round_bwd(dv, x["v0"], agg_cd, nm, wa_n, extra, width=L)
        ref = F.node_round_bwd_plain(x["dv"], x["v0"], agg_cd, nm, extra, width=L)
        torch.cuda.synchronize()
        errs = [check_bwd(f"{name} L {L} dv", dtype, dv, ref[0])[0],
                check_bwd(f"{name} L {L} dagg", dtype, got[0], ref[1])[0],
                check_saved(f"{name} L {L}", dtype, got[1], ref[2])]
        if extra is not None:
            errs.append(check_bwd(f"{name} L {L} dxtr", dtype, got[2], ref[3])[0])
            zero(f"{name} dxtr", got[2])
        k5[name] = max(errs)
        zero(name, dv, got[0], *got[1].dh, *got[1].post, got[1].ln)
        if extra is None:
            dagg, saved_n = ref[1], got[1]
    # K4, the three-part and the defer form
    k4 = {}
    de = x["de"].clone()
    dvs, dvr, saved3 = F.edge_round_bwd(de, dagg, x["e0"], p, q, t.senders, t.receivers, ev, em,
                                        wa_e, width=L)
    ref = F.edge_round_bwd_plain(x["de"], dagg, x["e0"], p, q, t.senders, t.receivers, ev, em,
                                 width=L)
    torch.cuda.synchronize()
    k4["edge_round_bwd"] = max(check_bwd(f"K4 L {L} de", dtype, de, ref[0])[0],
                               check_bwd(f"K4 L {L} dvs", dtype, dvs, ref[1])[0],
                               check_bwd(f"K4 L {L} dvr", dtype, dvr, ref[2])[0],
                               check_saved(f"K4 L {L}", dtype, saved3, ref[3]))
    zero("K4", de, dvs, dvr, *saved3.dh, *saved3.post, saved3.ln)
    de = x["de"].clone()
    saved = F.edge_round_bwd(de, dagg, x["e0"], p, q, t.senders, t.receivers, ev, em, wd_e,
                             defer=True, width=L)
    ref_de, ref_d = F.edge_round_bwd_plain(x["de"], dagg, x["e0"], p, q, t.senders, t.receivers,
                                           ev, em, defer=True, width=L)
    torch.cuda.synchronize()
    k4["edge_round_bwd_defer"] = max(check_bwd(f"K4 defer L {L} de", dtype, de, ref_de)[0],
                                     check_saved(f"K4 defer L {L}", dtype, saved, ref_d))
    zero("K4 defer", de, *saved.dh, *saved.post, saved.ln)
    # K1 and K1-perm on dh0, then K8
    g_s, g_r = dh0_sums(t, saved.dh[0])
    zero("G_s, G_r", g_s, g_r)
    dv = x["dv"].clone()
    F.first_layer_adjoint(dv, g_s, g_r, em, wa_p[size_p:])
    ref_dv = F.first_layer_adjoint_plain(x["dv"], g_s, g_r, em)
    torch.cuda.synchronize()
    k8 = check_bwd(f"K8 L {L} dv", dtype, dv, ref_dv)[0]
    zero("K8 dv", dv)
    # K6: one grouped call per MLP round (the defer_first edge group and the
    # node group) against the library route of the same products
    k6 = 0.0
    for m, sv, inputs, dfd in (("edge", saved, [(x["e0"], None)],
                                [(x["v0"], g_s), (x["v0"], g_r)]),
                               ("node", saved_n, [(x["v0"], None), (agg_cd, None)], [])):
        mlp = em if m == "edge" else nm
        grads = {"w": [torch.zeros((1,) + tuple(w.shape), device="cuda") for w in mlp["w"]],
                 "b": [torch.zeros((1, tile), device="cuda") for _ in mlp["w"]],
                 "ln_scale": torch.zeros((1, tile), device="cuda"),
                 "ln_bias": torch.zeros((1, tile), device="cuda")}
        F.mlp_wgrads(sv, inputs, grads, 0, deferred=dfd)
        ref = wgrad_library(sv, inputs, dfd)
        torch.cuda.synchronize()
        got = [g[0] for g in grads["w"]] + [g[0] for g in grads["b"]] + [
            torch.cat([grads["ln_scale"][0], grads["ln_bias"][0]])]
        k6 = max([k6] + [check_bwd(f"K6 {m} L {L} [{i}]", torch.float32, a, b)[0]
                         for i, (a, b) in enumerate(zip(got, ref))])
        zero(f"K6 {m}", *got)
    errs = dict(edge_project=k7, edge_round=k2[0], node_round=k3["node_round"][0],
                node_round_extra=k3["node_round_extra"][0], first_layer_adjoint=k8, wgrad=k6,
                **k4, **k5)
    short = {k: float(f"{v:.3e}") for k, v in errs.items()}
    log(f"  widths: L {L} on the {tile} tile {dtype}: every kernel within its rule, every "
        f"padded column 0; max_abs_err {json.dumps(short)}")
    return dict(out, errs=errs, saved=saved, g_s=g_s, g_r=g_r, dagg=dagg, agg_cd=agg_cd)


def width_times(t, w: dict, dtype) -> dict:
    """Each kernel's device ms at width ``w['L']`` on its padded tile (the
    cylinder's shapes, one round; the weight streams of MPS rounds in the
    serving form, as the full-width report times them), beside its bound at
    the real width."""
    L, tile, em, nm, ev = w["L"], w["tile"], w["em"], w["nm"], w["ev"]
    (ws_e, ws_n, ws_p), (wa_e, wa_n, wa_p) = w["ws"], w["wa"]
    n_pad, s, r = t.num_nodes, t.senders, t.receivers
    dh0 = w["saved"].dh[0]
    dw, db = torch.empty((tile, tile), device="cuda"), torch.empty((tile,), device="cuda")
    dw_rows = torch.empty((2 * tile, tile), device="cuda")
    e_t, v_t = w["e0"].clone(), w["v0"].clone()
    # the weight streams of a whole processor (MPS rounds) at this width, padded
    cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=L,
                    hidden_layers=HIDDEN, message_passing_steps=MPS)
    proc = init_mgn(cfg, torch.Generator().manual_seed(L), device="cuda")["processor"]
    em15, nm15 = (F.cast_mlp(F._pad_mlp(proc[m], L, tile), dtype)
                  for m in ("edge_mlp", "node_mlp"))
    runs = {
        "edge_project": lambda: F.edge_project(w["v0"], em, ws_p),
        "edge_round": lambda: F.edge_round(e_t, w["p"], w["q"], s, r, ev, em, ws_e, width=L),
        "csr_segment_sum": lambda: csr_segment_sum(w["msg"], r, t.row_offsets, n_pad),
        "csr_segment_sum_perm": lambda: csr_segment_sum(w["msg"], s, t.sender_offsets, n_pad,
                                                        perm=t.sender_perm),
        "node_round": lambda: F.node_round(v_t, w["agg"], nm, ws_n, width=L),
        "node_round_extra": lambda: F.node_round(v_t, w["agg"], nm, ws_n, w["extra"], width=L),
        "weight_streams": lambda: F.weight_streams(em15, nm15),
        "edge_round_bwd": lambda: F.edge_round_bwd(w["de"].clone(), w["dagg"], w["e0"], w["p"],
                                                   w["q"], s, r, ev, em, wa_e, width=L),
        "edge_round_bwd_defer": lambda: F.edge_round_bwd(
            w["de"].clone(), w["dagg"], w["e0"], w["p"], w["q"], s, r, ev, em, w["wd_e"],
            defer=True, width=L),
        "node_round_bwd": lambda: F.node_round_bwd(w["dv"].clone(), w["v0"], w["agg_cd"], nm,
                                                   wa_n, width=L),
        "node_round_bwd_extra": lambda: F.node_round_bwd(w["dv"].clone(), w["v0"], w["agg_cd"],
                                                         nm, wa_n, w["extra"], width=L),
        "first_layer_adjoint": lambda: F.first_layer_adjoint(w["dv"].clone(), w["g_s"],
                                                             w["g_r"], em, wa_p[w["size_p"]:]),
        "wgrad": lambda: F.wgrad(dh0, w["e0"], None, dw=dw, db=db),
        "wgrad_node_rows": lambda: F.wgrad_group([
            F.WgradProduct(w["g_s"], [(w["v0"], None)], dw_rows[:tile]),
            F.WgradProduct(w["g_r"], [(w["v0"], None)], dw_rows[tile:])]),
    }
    match = {"csr_segment_sum_perm": "csr_segment_sum", "node_round_extra": "node_round",
             "edge_round_bwd_defer": "edge_round_bwd", "node_round_bwd_extra": "node_round_bwd",
             "wgrad_node_rows": "wgrad"}
    bounds = width_bounds(L, dtype, n_pad, t.num_edges)
    res = {}
    for name, fn in runs.items():
        ms = device_ms(fn, 100, match=match.get(name, name), kernels=1)
        nbytes, ops, peak = bounds[name]
        b_ms, b_by = bound_ms(nbytes, ops, peak)
        res[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=w["errs"].get(name))
    # K1's tail form at the flag's width 90 (its world set's sums, the gathers' backward)
    real = w["msg"][:, :WIDTH_CLOTH].contiguous()
    res["csr_segment_sum_tail"] = dict(ms=device_ms(
        lambda: csr_segment_sum(real, r, t.row_offsets, n_pad), 100, match="csr_segment_sum",
        kernels=1), bound_ms=bound_ms(*width_bounds(WIDTH_CLOTH, dtype, n_pad,
                                                      t.num_edges)["csr_segment_sum"])[0])
    log(f"  widths: device ms at L {L} on the {tile} tile {dtype} (bound at the real width): "
        + ", ".join(f"{k} {v['ms']:.5f} ({v['bound_ms']:.5f})" for k, v in res.items()))
    return res


@contextlib.contextmanager
def plain_route(module):
    """``module.fused_process`` (models.mgn's or models.mgn_multi's)
    replaced by process_rounds_plain in its pre-projected form at the
    model's own width (no padding): the plain route, on the card."""
    def plain(proc, v0, e0, senders, receivers, row_offsets, edge_valid, mps,
              return_edges=False, sender_perm=None, sender_offsets=None, node_extra=None):
        hook = (lambda r, v: node_extra) if isinstance(node_extra, torch.Tensor) else node_extra
        return F.process_rounds_plain(proc, v0, e0, senders, receivers, edge_valid, mps,
                                      v0.dtype, v0.shape[0], return_edges, hook, preproject=True)

    inner = module.fused_process
    module.fused_process = plain
    try:
        yield
    finally:
        module.fused_process = inner


class PadWatch:
    """While entered, the backward's kernels (K5, K4, K8, and K7's
    recompute) are wrapped so that every tensor they read or write that is
    as wide as the tile — the saved v, e and aggregate, P and Q, the dv and
    de carries, dagg, G_s, G_r, each layer's dh and ReLU output, the
    LayerNorm partial sums — is checked: every padded column exactly 0."""

    NAMES = ("node_round_bwd", "edge_round_bwd", "first_layer_adjoint", "edge_project")

    def __init__(self, width: int, tile: int):
        self.width, self.tile, self.seen = width, tile, 0

    def check(self, name, *ts):
        for x in ts:
            if isinstance(x, F.MlpSaved):
                self.check(name, *x.dh, *x.post, x.ln)
            elif isinstance(x, (tuple, list)):
                self.check(name, *x)
            elif isinstance(x, torch.Tensor) and x.dim() == 2 and x.shape[-1] in (
                    self.tile, 2 * self.tile):
                pad_is_zero(f"{name} in a training step", x, self.width, self.tile)
                self.seen += 1

    def __enter__(self):
        self.inner = {n: getattr(F, n) for n in self.NAMES}

        def wrap(name, fn):
            def run(*args, **kw):
                self.check(name, *args)
                result = fn(*args, **kw)
                self.check(name, *args, result)
                return result
            run.__dict__ = fn.__dict__  # the launch counters, which the kernels raise by name
            return run

        for n, fn in self.inner.items():
            setattr(F, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.inner.items():
            setattr(F, n, fn)


def width_model(workdir, call) -> dict:
    """The cylinder model at WIDTH_MODEL (padded to 128; 15 rounds, 2 hidden
    layers): simulate's 10 Euler steps in f32 and bf16 and one frame's
    gradient and one noise-free derivative step on phase_training's dataset,
    each against the plain route on the card; the padded columns in the
    backward; device busy of a serving call and a training step beside the
    same at 128 (``call``, phase_serving's, cut to 10 steps)."""
    from mgn_tpu_torch.checkpoint.manager import load_model
    from mgn_tpu_torch.models import mgn as mgn_module

    L, out = WIDTH_MODEL, {}
    sub = os.path.join(workdir, f"w{L}")
    os.makedirs(sub, exist_ok=True)
    c96 = serving_call(sub, L, WIDTH_STEPS)
    c128 = dict(call, times=call["times"][:WIDTH_STEPS + 1])
    for dt in ("float32", "bfloat16"):
        reset_counts()
        pred = simulate(**c96, compute_dtype=dt)
        counts = {k: read_counts()[k] for k in FORWARD}
        with plain_route(mgn_module):
            ref = simulate(**c96, compute_dtype=dt)
        err, rel = float(np.abs(pred - ref).max()), rel_l2(pred, ref, ref)
        ok = err <= 1e-3 if dt == "float32" else rel <= 5e-2
        log(f"  widths: simulate at layer_size {L} {dt}, {WIDTH_STEPS} Euler steps: launches "
            f"{counts}; against the plain route on the card max_abs_err {err:.3e}, rel_l2 "
            f"{rel:.3e} (tolerance: f32 max_abs 1e-3, bf16 rel_l2 5e-2)")
        want = {k: WIDTH_STEPS * (1 if k == "weight_streams" else MPS) for k in FORWARD}
        if not ok or counts != want or not np.isfinite(pred).all():
            raise AssertionError(f"simulate at {L} {dt}: max_abs_err {err:.3e}, rel_l2 "
                                 f"{rel:.3e}, launches {counts} (expected {want})")
        out[f"simulate_{dt}"] = dict(max_abs_err=err, rel_l2=rel, launches=counts)
    out["serving_busy_ms"] = {str(L): profile_serving(c96)["device_busy_ms"],
                              str(LATENT): profile_serving(c128)["device_busy_ms"]}

    ds = os.path.join(workdir, "ds")
    _, norm = load_model(os.path.join(workdir, "cp_train"), False, torch.device(DEVICE))
    dataset = load_dataset(ds)
    meta = dataset.meta
    nb, eb = common_buckets([dataset.structure(0)], meta, 128, 512)
    steps = {}
    for width in (L, LATENT):
        cfg, spec = build_model_config(meta, Args(mps=MPS, layer_size=width,
                                                  hidden_layers=HIDDEN))
        prep = prepare_trajectory(dataset.trajectory(0), meta, spec, nb, eb, device=DEVICE)
        params = grad_copy(init_mgn(cfg, torch.Generator().manual_seed(width), device=DEVICE))
        steps[width] = (cfg, spec, prep, params)
    cfg, spec, prep, params = steps[L]
    reset_counts()
    with PadWatch(L, F.kernel_width(L)) as watch:
        loss_k, g_k = frame_loss_grads(grad_copy(params), norm, prep, 3, cfg, spec)
    counts = read_counts()
    with plain_route(mgn_module):
        loss_p, g_p = frame_loss_grads(grad_copy(params), norm, prep, 3, cfg, spec)
    log(f"  widths: one frame's gradient at layer_size {L}: loss {float(loss_k.detach()):.7f}, plain "
        f"route {float(loss_p.detach()):.7f}; launches {counts}; {watch.seen} tile-wide tensors of the "
        "backward checked, every padded column 0")
    needed = ("edge_round_bwd_defer", "node_round_bwd", "wgrad", "first_layer_adjoint",
              "csr_segment_sum_perm", "edge_round", "node_round", "edge_project")
    if any(counts[k] <= 0 for k in needed) or watch.seen < 10 * MPS:
        raise AssertionError(f"the gradient at {L} did not run every kernel: {counts}, "
                             f"{watch.seen} tensors checked")
    out["grad"] = check_grads(f"whole-model gradient at layer_size {L}, kernels vs the plain "
                              "route on the card", torch.float32, g_k, g_p)
    step_losses = []
    for route in ("kernels", "plain"):
        p = grad_copy(params)
        st = TrainState(p, torch.optim.Adam(param_leaves(p), lr=1e-4), norm, 0)
        tr = make_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.0,), norm_steps=0))
        with (plain_route(mgn_module) if route == "plain" else contextlib.nullcontext()):
            _, losses = tr(st, prep.template, prep.fields, prep.times, [3],
                           torch.Generator(device=DEVICE).manual_seed(0))
        step_losses.append(float(losses[0]))
    step_rel = abs(step_losses[0] - step_losses[1]) / abs(step_losses[1])
    log(f"  widths: one noise-free derivative step at layer_size {L}: loss {step_losses[0]:.7f}, "
        f"plain route {step_losses[1]:.7f}, relative difference {step_rel:.3e} (tolerance 1e-3)")
    if not step_rel <= 1e-3:
        raise AssertionError(f"the derivative step at {L} differs from the plain route by "
                             f"{step_rel:.3e}")
    out["step_rel_diff"] = step_rel
    busy = {}
    for width, (cfg_w, spec_w, prep_w, params_w) in steps.items():
        p = grad_copy(params_w)
        st = TrainState(p, torch.optim.Adam(param_leaves(p), lr=1e-4), norm, 0)
        tr = make_derivative_trainer(DerivativeTrainerConfig(cfg_w, spec_w, (0.0,),
                                                             norm_steps=0))
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        tr(st, prep_w.template, prep_w.fields, prep_w.times, [1], gen)  # warm
        busy[str(width)] = profile_training(lambda: tr(st, prep_w.template, prep_w.fields,
                                                       prep_w.times, [2, 4], gen), 2)
    out["training_busy_ms"] = {k: v.get("device_busy_ms_per_step") for k, v in busy.items()}
    out["training_kernels_per_step"] = {k: v.get("device_kernels_total_per_step")
                                        for k, v in busy.items()}
    log(f"  widths: device busy ms at layer_size {L} beside {LATENT}: serving call of "
        f"{WIDTH_STEPS} steps {out['serving_busy_ms']}, training step "
        f"{out['training_busy_ms']}; device kernels a training step "
        f"{out['training_kernels_per_step']}")
    return out


def width_cloth(cloth_dir) -> dict:
    """The cloth family at WIDTH_CLOTH (padded to 128) on phase_cloth_training's
    flag dataset, through K3's and K5's extra forms and K1-perm at the
    model's width (the world set): train_network 20 steps, as that phase
    trains at 128, then on the trained state one frame's whole-model
    gradient against the CPU plain path (check_grads, on world edges built
    once on the CPU) and one noise-free cloth trainer step against the
    plain route on the card.  (At initialisation this frame's gradient is
    ill-conditioned in the world encoder's leaves: two f32 plain paths, the
    card's and the CPU's, differ there beyond check_grads' share rule; see
    PERF.md §6.)"""
    from mgn_tpu_torch.api_cloth import init_cloth_state
    from mgn_tpu_torch.models import mgn_multi as multi_module
    from mgn_tpu_torch.train.cloth import cloth_world_edges, make_cloth_trainer

    L = WIDTH_CLOTH
    ds, cp = os.path.join(cloth_dir, "flag_ds"), os.path.join(cloth_dir, f"cp_cloth{L}")
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-4)
    model = dict(mps=MPS, layer_size=L, hidden_layers=HIDDEN)
    metrics = MetricsLogger(quiet=True)
    reset_counts()
    state, _ = train_network(CLOTH_TRAIN["noise"], adam, ds, cp, metrics=metrics, device=DEVICE,
                             steps=CLOTH_TRAIN["steps"], norm_steps=CLOTH_TRAIN["norm_steps"],
                             checkpoint=CLOTH_TRAIN["checkpoint"], seed=0, **model)
    counts = read_counts()
    losses = [r["loss"] for r in metrics.records if r["kind"] in ("train", "valid")]
    log(f"  widths: the flag's train_network at layer_size {L}: {state.step} steps, losses "
        f"{[round(x, 6) for x in losses]}; launches {counts}")
    if state.step != CLOTH_TRAIN["steps"] or not np.isfinite(losses).all() or any(
            counts[k] <= 0 for k in ("node_round_extra", "node_round_bwd_extra",
                                     "csr_segment_sum_perm", "edge_round_bwd_defer", "wgrad")):
        raise AssertionError(f"cloth training at {L}: step {state.step}, losses {losses}, "
                             f"launches {counts}")
    dataset = load_dataset(ds)
    meta = dataset.meta
    nb, eb = common_buckets([dataset.structure(0)], meta, 128, 512)
    _, cfg, spec = init_cloth_state(meta, Args(norm_steps=0, **model), adam, 0.0, nb, DEVICE)
    prep = prepare_trajectory(dataset.trajectory(0), meta, spec, nb, eb, device=DEVICE)
    tm, wp, times = prep.template, prep.fields["world_pos"], prep.times
    frame = 7
    tm_c, wp_c, times_c = tm.to("cpu"), wp.cpu(), times.cpu()
    we_cpu = cloth_world_edges(tm_c, wp_c[frame], cfg)
    we = tuple(x.to(DEVICE) for x in we_cpu)
    loss_k, g_k = cloth_frame_grads(grad_copy(state.params), state.norm, tm, wp, times, frame,
                                    cfg, we)
    loss_c, g_c = cloth_frame_grads(grad_copy(state.params, "cpu"), state.norm.to("cpu"), tm_c,
                                    wp_c, times_c, frame, cfg, we_cpu)
    log(f"  widths: the flag at layer_size {L}, frame {frame}: loss {float(loss_k.detach()):.7f}, "
        f"cpu {float(loss_c.detach()):.7f}")
    grad = check_grads(f"cloth whole-model gradient at layer_size {L}, cuda vs cpu plain path",
                       torch.float32, [g.cpu() for g in g_k], g_c)
    steps = []
    cfg0 = dataclasses.replace(cfg, noise_stddev=0.0, norm_steps=0)
    for route in ("kernels", "plain"):
        p = grad_copy(state.params)
        st = TrainState(p, adam(param_leaves(p)), state.norm, 0)
        with (plain_route(multi_module) if route == "plain" else contextlib.nullcontext()):
            _, ls = make_cloth_trainer(cfg0)(st, tm, wp, times, [frame],
                                             torch.Generator(device=DEVICE).manual_seed(0))
        steps.append(float(ls[0]))
    rel = abs(steps[0] - steps[1]) / abs(steps[1])
    log(f"  widths: one noise-free cloth step at layer_size {L}: loss {steps[0]:.7f}, plain "
        f"route {steps[1]:.7f}, relative difference {rel:.3e} (tolerance 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"the cloth step at {L} differs from the plain route by {rel:.3e}")
    return dict(grad=grad, step_rel_diff=rel, launches=counts, losses=losses)


def phase_widths(workdir, cloth_dir, call) -> dict:
    """Latent widths the kernels are not built for, after every other phase
    (its profiles run last): every kernel at widths 90, 96 and 200 on its
    padded tile against its plain version, f32 and bf16, and its device ms
    at 96 beside its bound at 96; the cylinder model at 96 and the flag at
    90 through the kernels against the plain route on the card; the command
    line's train at 96."""
    log("phase widths")
    t0 = time.perf_counter()
    t = cylinder()[3]
    gen = torch.Generator(device="cuda").manual_seed(25)
    res = {"kernels": {}, "times": {}}
    with torch.no_grad():
        for L in WIDTHS:
            for dtype in (torch.float32, torch.bfloat16):
                w = width_kernels(t, L, dtype, gen)
                res["kernels"][f"{L} {dtype}"] = w["errs"]
                if L == WIDTH_MODEL:
                    res["times"][str(dtype)] = width_times(t, w, dtype)
    res["model"] = width_model(workdir, call)
    # the command line at the model's width, a process of its own beside the cloth
    # checks (which profile nothing): 2 derivative steps and their validation sweep
    argv = ["train", os.path.join(workdir, "ds"), os.path.join(workdir, f"cli_cp{WIDTH_MODEL}"),
            "--layer-size", str(WIDTH_MODEL), "--steps", "2", "--checkpoint", "2",
            "--norm-steps", "1", "--seed", "0", "--device", DEVICE]
    t_cli = time.perf_counter()
    cli = subprocess.Popen([sys.executable, "-m", "mgn_tpu_torch", *argv],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        res["cloth"] = width_cloth(cloth_dir)
        stdout, stderr = cli.communicate(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    records = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    losses = [x["loss"] for x in records if x["kind"] == "train"]
    res["cli"] = dict(rc=cli.returncode, s=time.perf_counter() - t_cli, losses=losses,
                      kinds=sorted({x["kind"] for x in records}))
    log(f"  widths: python -m mgn_tpu_torch train --layer-size {WIDTH_MODEL}: exit "
        f"{cli.returncode} in {res['cli']['s']:.1f} s; records {res['cli']['kinds']}, losses "
        f"{losses}; stderr tail {stderr.strip().splitlines()[-1:]}")
    if cli.returncode != 0 or not losses or not np.isfinite(losses).all() or \
            "checkpoint" not in res["cli"]["kinds"]:
        raise AssertionError(f"train --layer-size {WIDTH_MODEL}: exit {cli.returncode}, "
                             f"losses {losses}, stderr {stderr[-2000:]}")
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase widths: {res['seconds']:.1f} s")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--k3-bits":
        return k3_bits(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--k5-bits":
        return k5_bits(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--proj-bits":
        torch.backends.cuda.matmul.allow_tf32 = False
        return proj_bits(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--k2-bits":
        return k2_bits(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "--k2-time":
        return k2_time()
    if len(sys.argv) == 2 and sys.argv[1] == "--k1-time":
        return k1_time()
    if len(sys.argv) == 2 and sys.argv[1] == "--k6-time":
        torch.backends.cuda.matmul.allow_tf32 = False
        k6_time()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--ws-time":
        return ws_time()
    if len(sys.argv) == 2 and sys.argv[1] == "--host-time":
        return host_time()
    if len(sys.argv) == 3 and sys.argv[1] == "--export-flag":
        return export_flag(sys.argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase build")
    t_start = t0 = time.perf_counter()
    info = _build.build_all()
    log(f"  built {sorted(info)} in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    ptxas = {}  # kernel form -> its register and spill lines
    for name, i in sorted(info.items()):
        kernel = ""
        for line in i["log"].splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                ptxas.setdefault(kernel, []).append(line.split(":", 1)[-1].strip())
                log(f"  ptxas[{name}] {kernel}: {ptxas[kernel][-1]}")
    k5_ptxas = {k: "; ".join(v) for k, v in ptxas.items()
                if k.startswith("node_round_bwd_kernel")}

    pos, cells, nt, t = cylinder()
    *_, t20k = cylinder(20000)
    log(f"cylinder mesh: N {len(pos)} (N_pad {t.num_nodes}), E {int(t.edge_mask.sum())} "
        f"(E_pad {t.num_edges}), max real in-degree "
        f"{int(torch.diff(t.row_offsets)[:-1].max())}, trash-row edges "
        f"{int(torch.diff(t.row_offsets)[-1])}")
    # the export phase's flag artefact, the longest export, is made by a process
    # of its own from here on: host work that overlaps the earlier phases
    with background_flag_export() as flag_job:
        probes = phase_probes(t)
        k1 = phase_k1(t, t20k)
        proc = processor(3)
        fs = flag_setup()
        with torch.no_grad():
            k7 = phase_k7([("cylinder", t.num_nodes), ("flag", fs["tmpl"].num_nodes),
                           ("20k-node mesh", t20k.num_nodes)], proc)
            proc_res = phase_processor(t, t20k, proc)
            streams = phase_weight_streams(t, proc)
        bwd = phase_backward(t, t20k, proc, fs["tmpl"].to("cuda"))
        grad = phase_processor_grad(t, proc)
        # the union and eval phases come last, on the datasets and checkpoints the
        # training phases leave: every earlier phase runs as it did without them
        with tempfile.TemporaryDirectory() as workdir, tempfile.TemporaryDirectory() as cloth_dir:
            launches, serving, call = phase_serving(workdir)
            serving["adaptive"] = phase_adaptive(call)
            train_launches, per_step, training = phase_training(workdir)
            with torch.no_grad():
                k3x = phase_k3_extra(fs["tmpl"], proc)
            cloth = phase_cloth(fs)
            k5x = phase_k5_extra(fs["tmpl"], proc)
            cloth_launches, cloth_per_step, cloth_train = phase_cloth_training(cloth_dir, fs)
            union = phase_union_training(workdir, training)
            evaluation = phase_eval(workdir)
            evaluation["cloth"] = phase_eval_cloth(cloth_dir)
            solver = phase_solver_training(workdir)
            cli = phase_cli(workdir)
            export = phase_export(workdir, call, fs, flag_job)
            families = phase_families(workdir, os.path.join(cloth_dir, "flag_ds"))
            parallel = phase_parallel(workdir)
            parallel_train = phase_parallel_train(workdir)
            artefacts = phase_artefacts(workdir, call)
            widths = phase_widths(workdir, cloth_dir, call)

    f32, bf16 = torch.float32, torch.bfloat16
    fwd_src, bwd_src = ("mgn_tpu_torch/ops/csrc/fused_round.cu",
                        "mgn_tpu_torch/ops/csrc/fused_round_bwd.cu")
    # name -> (source, TPU kernel it replaces, launches on its path, f32 results);
    # the forward kernels count the serving run, the backward ones the training run
    sources = {
        "csr_segment_sum": ("mgn_tpu_torch/ops/csrc/csr_segment.cu",
                            "mgn_tpu/ops/pallas_segment.py:122", launches, k1[f32]),
        "edge_project": (fwd_src, "mgn_tpu/ops/fused.py:453", launches, k7[f32]),
        "edge_round": (fwd_src, "mgn_tpu/ops/fused.py:469", launches,
                       proc_res[f32]["edge_round"]),
        "node_round": (fwd_src, "mgn_tpu/ops/fused.py:553", launches,
                       proc_res[f32]["node_round"]),
        "weight_streams": ("mgn_tpu_torch/ops/csrc/stream_tile.cuh", "mgn_tpu/ops/fused.py:1630",
                           launches, proc_res[f32]["weight_streams"]),
        # K4's three-part form: the processor gradient's run with it pinned (the
        # backward's form at E < N); every mesh here takes the defer_first form
        "edge_round_bwd": (bwd_src, "mgn_tpu/ops/fused.py:888",
                           grad[f32]["three_part_launches"], bwd[f32]["edge_round_bwd"]),
        "edge_round_bwd_defer": (bwd_src, "mgn_tpu/ops/fused.py:966", train_launches,
                                 bwd[f32]["edge_round_bwd_defer"]),
        "first_layer_adjoint": (bwd_src, "mgn_tpu/ops/fused.py:1071", train_launches,
                                bwd[f32]["first_layer_adjoint"]),
        "node_round_bwd": (bwd_src, "mgn_tpu/ops/fused.py:855", train_launches,
                           bwd[f32]["node_round_bwd"]),
        "wgrad": ("mgn_tpu_torch/ops/csrc/wgrad.cu", "mgn_tpu/ops/fused.py:288",
                  train_launches, dict(bwd[f32]["wgrad"], node_rows=bwd[f32]["wgrad_node_rows"],
                                       node_rows_bf16=bwd[bf16]["wgrad_node_rows"])),
        "csr_segment_sum_perm": ("mgn_tpu_torch/ops/csrc/csr_segment.cu",
                                 "mgn_tpu/ops/fused.py:1036", train_launches,
                                 bwd[f32]["csr_segment_sum_perm"]),
        "node_round_extra": (fwd_src, "mgn_tpu/ops/fused.py:560", cloth[f32]["launches"],
                             k3x[f32]),
        "node_round_bwd_extra": (bwd_src, "mgn_tpu/ops/fused.py:880", cloth_launches,
                                 k5x[f32]),
    }
    # the cloth family's forms: launches per step of the cloth training run
    step_counts = dict(per_step, node_round_extra=cloth_per_step["node_round_extra"],
                       node_round_bwd_extra=cloth_per_step["node_round_bwd_extra"])
    # the counters count wrapper calls; the device kernels each call made in
    # the profiled training steps (K1 and K1-perm share one kernel)
    per_call = training["profile"].get("device_kernels_per_call") or {}
    kernels = []
    for name, (src, replaces, counts, r) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name],
                        "launches_per_training_step": step_counts[name],
                        "launches_per_union_step": union["calls_per_step"][name],
                        # rank 0 of the graph-parallel phase's mesh (1, 2): train_network's
                        # 10 steps, simulate(graph_parallel=2)'s 20 Euler steps (deep)
                        "launches_parallel_train": parallel["ranks"][0]["train_launches"][name],
                        "launches_parallel_serve":
                            parallel["ranks"][0]["simulate_deep_launches"][name],
                        # rank 0 of phase_parallel_train's mesh (1, 2): train_network's
                        # SolverTraining steps; the telescoped simulate and one frame's
                        # gradient; the cloth family's train_network steps
                        **{f"launches_parallel_{path}":
                           parallel_train["ranks"][0][f"{path}_launches"][name]
                           for path in ("solver", "telescope", "cloth")},
                        # phase_artefacts: the adaptive artefact's call (the cylinder, 5
                        # save intervals) and rank 0's deep Euler sharded artefact (5 steps)
                        "launches_adaptive_artefact":
                            artefacts["adaptive"]["launches"].get(name, 0),
                        "launches_sharded_artefact":
                            artefacts["sharded"]["deep euler"]["launches"][0].get(name, 0),
                        "device_launches_per_call": per_call.get(name.replace("_perm", "")),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        **{k: r[k] for k in ("bound_tc_ms", "bound_tc_by", "cold_l2_ms",
                                             "node_rows", "node_rows_bf16") if k in r},
                        # phase_widths: f32 device ms at width 96 on the 128 tile, and the
                        # bound at the real width 96
                        **{f"{k}_at_{WIDTH_MODEL}": widths["times"][str(f32)][name][k]
                           for k in ("ms", "bound_ms")}})
    # K5 inside the training steps (device ms per launch, profiler) and its
    # ptxas report, every form
    for k in kernels:
        if k["name"].startswith("node_round_bwd"):
            prof = (cloth_train if k["name"].endswith("extra") else training)["profile"]
            k["in_step_ms"] = (prof.get("device_ms_per_launch") or {}).get("node_round_bwd")
            k["ptxas"] = k5_ptxas
    # K9 and K10: their launches are the probes' runs (graph replays included);
    # no training step runs them
    k9, k10 = probes["k9"], probes["k10"]
    for name, replaces, r, variants in (
            ("window_gather", "benchmarks/probe_dyngather_tpu.py:58", k9["onehot_f32"], k9),
            ("onehot_pair", "benchmarks/probe_onehot_dtype_tpu.py:60", k10["bf16"], k10)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "mgn_tpu_torch/ops/csrc/onehot_probe.cu", "replaces": replaces,
                        "launches": probes["launches"][name], "launches_per_training_step": None,
                        "launches_per_union_step": None, "launches_parallel_train": None,
                        "launches_parallel_serve": None, "launches_parallel_solver": None,
                        "launches_parallel_telescope": None, "launches_parallel_cloth": None,
                        "launches_adaptive_artefact": None, "launches_sharded_artefact": None,
                        "device_launches_per_call": None,
                        "max_abs_err": max(x["max_abs_err"] for x in variants.values()),
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        **{k: r[k] for k in ("bound_tc_ms", "bound_tc_by") if k in r},
                        "variant": "onehot_f32" if name == "window_gather" else "bf16",
                        "variants": variants})
    for dtype, g in probes["k2_gathers"].items():
        k2_ms = proc_res[dtype]["edge_round"]["ms"]
        log(f"K2's gathers at the cylinder {dtype}: K9 direct {g['ms']:.5f} ms "
            f"({g['l2_mb']:.2f} MB of rows) against K2 {k2_ms:.5f} ms in this run: "
            f"{g['ms'] / k2_ms:.3f} of K2")
    log("bf16: " + json.dumps({
        "csr_segment_sum": k1[bf16], "edge_project": k7[bf16],
        **{k: proc_res[bf16][k] for k in ("edge_round", "node_round", "weight_streams")},
        **{k: v for k, v in proc_res[bf16].items() if k.startswith("forward")},
        **{k: v for k, v in bwd[bf16].items()}}))
    log("weight streams: " + json.dumps(streams))
    log("f32 processor forward: " + json.dumps(
        {k: v for k, v in proc_res[f32].items() if k.startswith("forward")}))
    log("K6 per round: " + json.dumps({str(k): v["wgrad_round"] for k, v in bwd.items()}))
    log("processor gradient: " + json.dumps({str(k): v for k, v in grad.items()}))
    log("serving: " + json.dumps(serving))
    log("training launches: " + json.dumps(train_launches))
    log("training: " + json.dumps(training))
    log("union training: " + json.dumps(union))
    log("eval: " + json.dumps(evaluation))
    log("solver training: " + json.dumps(solver))
    log("cli: " + json.dumps(cli))
    log("export: " + json.dumps(export))
    log("families: " + json.dumps(families))
    log("parallel: " + json.dumps(parallel, default=str))
    log("parallel train: " + json.dumps(parallel_train, default=str))
    log("artefacts: " + json.dumps(artefacts, default=str))
    log("widths: " + json.dumps(widths, default=str))
    log("K3 extra: " + json.dumps({str(k): v for k, v in k3x.items()}))
    log("cloth serving: " + json.dumps({str(k): v for k, v in cloth.items()}))
    log("K5 extra: " + json.dumps({str(k): v for k, v in k5x.items()}))
    log("cloth training launches: " + json.dumps(cloth_launches))
    log("cloth training: " + json.dumps(cloth_train))
    log(f"cloth training: {cloth_train['ms_per_step']:.3f} ms per step f32 (host clock, "
        f"{FLAG['frames'] - 2} steps), peak device memory {cloth_train['step_peak_mib']:.1f} MiB")
    log(f"cloth serving: {cloth[f32]['ms_per_step']:.3f} ms per step f32, "
        f"{cloth[bf16]['ms_per_step']:.3f} bf16 (host clock, median of 3 calls of "
        f"{FLAG['frames'] - 2} steps)")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
