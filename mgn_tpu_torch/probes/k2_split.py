"""Where K2's time goes: ablated and timestamped copies of its edge tile.

K2 (``edge_round``, ``ops/csrc/fused_round.cu`` on ``ops/csrc/edge_tile.cuh``)
runs one 64-edge tile a block: the tile's ``e`` rows and indices, three
products fed by the block's ring of weight copies (``EdgeRingFeed``), the
``P[s] + Q[r]`` reads, LayerNorm and the epilogue's stores.  A profiler
sees one kernel.  This probe copies the kernel sources of a tree
(``--csrc``, by default this tree's), builds variants of them with ``nvcc``
and times each at the cylinder's shape (E_pad 11,264, N_pad 1,920, latent
128, 2 hidden layers), f32 and bf16:

- ``full``: the sources as they are;
- ``ring_once``: the ring is filled once and every later chunk reuses it
  (no weight copy after the first ``kStages`` chunks, the block barrier a
  chunk kept): ``full`` minus this is the weight feed's share;
- ``one_partial``: f32 waits for each ``wgmma`` partial before it issues
  the next, as K4 does;
- ``stamped``: ``full`` with SM-clock stamps written by each block's
  thread 0 at the phase boundaries (entry, indices, ``e`` rows, first
  product, ``P``/``Q``, later products, LayerNorm, end) and its time spent
  waiting for its chunks, averaged over the blocks of 20 launches and
  turned into us by each block's own clock-to-globaltimer ratio.

The ``parent_*`` variants split the K2 that ran K4's ``EdgeBlock`` feed
(11b02ae's sources, ``--csrc``): ``parent_ring_once``, ``parent_no_gather``
(no ``e`` rows), ``parent_no_pq``, ``parent_no_ln`` (no LayerNorm row sums),
``parent_no_epilogue`` (no ``msg``/``e`` stores, a checksum keeps the math)
and ``parent_stamped`` (the same stamps without the chunk waits).

The patches are textual.  Each names the struct or function of K2 it
targets, and its anchor must occur once in the file and inside that
definition, or the probe raises: a patch never lands in K4's ``EdgeBlock``
(the same header) and never times an unchanged K2.  ``full`` applies to
any tree, the ``parent_*`` variants only where K2's kernel constructs an
``EdgeBlock``, the others to this tree's sources.  Run on the card from
the repository root::

    python -m mgn_tpu_torch.probes.k2_split [--csrc DIR] [--variants ...] [--out FILE]

Prints one JSON line, ``k2-split:``, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mgn_tpu_torch.probes import card

__all__ = ["PATCHES", "VARIANTS", "PARENT_VARIANTS", "patched", "sources", "main"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "ops", "csrc")
_STAMPS = 12  # slots a block: 8 clocks, the entry and end globaltimer, the chunk waits
_PARENT_STAMPS = 10  # the same without the chunk waits

# the definitions the patches target, by the text that starts each
_RING_FEED = "struct EdgeRingFeed {"
_TILE = "struct EdgeRoundTile {"
_FORWARD = "edge_mlp_forward(Block& b,"
_KERNEL = "edge_round_kernel(T* e,"

_STAMP_DECL = (
    "namespace mgn {\n\n"
    "__device__ long long mgn_stamps[4096 * 12];\n"
    "__device__ __forceinline__ void mgn_tstamp(int k, bool leader, int tile) {\n"
    "  if (leader) mgn_stamps[tile * 12 + k] = clock64();\n"
    "}\n"
    "__device__ __forceinline__ void mgn_twait(long long c, bool leader, int tile) {\n"
    "  if (leader) mgn_stamps[tile * 12 + 10] += c;\n"
    "}\n"
    "__device__ __forceinline__ void mgn_tgtime(int k, bool leader, int tile) {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  if (leader) mgn_stamps[tile * 12 + k] = static_cast<long long>(t);\n"
    "}\n\n")

# the stamps' way out (and back, cleared) of the device
_STAMP_IO = (
    "fused_round.cu", None, "const char* mgn_cuda_error_string(int code) {",
    "int mgn_read_stamps(long long* host, int n) {\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(host, mgn::mgn_stamps,\n"
    "                                                sizeof(long long) * n));\n}\n"
    "int mgn_write_stamps(const long long* host, int n) {\n"
    "  return static_cast<int>(cudaMemcpyToSymbol(mgn::mgn_stamps, host,\n"
    "                                              sizeof(long long) * n));\n}\n\n"
    "const char* mgn_cuda_error_string(int code) {")

_RING = "  const mgn::EdgeRingFeed<T, L> ring(smem, wstream, p.n_layers * C::kChunks);\n"
_TILE_START = ("  const mgn::TileLane& me = b.me;\n"
               "  const int grow[2] = {b.rid[me.row[0]], b.rid[me.row[1]]};\n")
_KERNEL_END = "    mgn::store_pack<T, E>(e + off, x[it]);\n  }\n}\n"
_LN_END = ("      acc[j][k] = col < p.real ? (acc[j][k] - mean[k / 2]) * rstd[k / 2] : 0.f;\n"
           "    }\n}\n")
_LEAD = "b.me.tid == 0, blockIdx.x"
_KLEAD = "threadIdx.x == 0, blockIdx.x"

# variant -> [(file, target definition or None for the file, anchor, replacement)]
PATCHES: Dict[str, List[Tuple[str, Optional[str], str, str]]] = {
    "full": [],
    "ring_once": [
        ("edge_tile.cuh", _RING_FEED, "    mbar_wait(&full[g % S], (g / S) & 1);\n",
         "    if (g < S) mbar_wait(&full[g % S], (g / S) & 1);\n"),
        ("edge_tile.cuh", _RING_FEED,
         "      if (threadIdx.x == 0 && g - 1 + S < total) fill(g - 1 + S);\n", "")],
    "one_partial": [
        ("edge_tile.cuh", _TILE, "      chunk<T, L, true>(acc, As, ring.stage(cur), c, me);",
         "      chunk<T, L>(acc, As, ring.stage(cur), c, me);")],
    "stamped": [
        ("edge_tile.cuh", None, "namespace mgn {\n\n", _STAMP_DECL),
        ("fused_round.cu", _KERNEL, _RING,
         f"  mgn::mgn_tgtime(8, {_KLEAD});\n  mgn::mgn_tstamp(0, {_KLEAD});\n" + _RING),
        ("fused_round.cu", _KERNEL, _TILE_START, _TILE_START + f"  mgn::mgn_tstamp(1, {_LEAD});\n"),
        ("edge_tile.cuh", _FORWARD, "  b.gather_e();\n  b.product(acc);\n",
         f"  b.gather_e();\n  mgn_tstamp(2, {_LEAD});\n  b.product(acc);\n"
         f"  mgn_tstamp(3, {_LEAD});\n"),
        ("edge_tile.cuh", _FORWARD,
         "  add_bias<T, L>(acc, static_cast<const T*>(p.b[0]), b.me);\n",
         f"  mgn_tstamp(4, {_LEAD});\n"
         "  add_bias<T, L>(acc, static_cast<const T*>(p.b[0]), b.me);\n"),
        ("edge_tile.cuh", _FORWARD,
         "  // LayerNorm statistics (f32, two passes as the plain version) over the\n",
         f"  mgn_tstamp(5, {_LEAD});\n"),
        ("edge_tile.cuh", _FORWARD, _LN_END, _LN_END[:-2] + f"\n  mgn_tstamp(6, {_LEAD});\n}}\n"),
        ("fused_round.cu", _KERNEL, _KERNEL_END,
         _KERNEL_END[:-2] + f"  mgn::mgn_tstamp(7, {_KLEAD});\n"
         f"  mgn::mgn_tgtime(9, {_KLEAD});\n}}\n"),
        ("edge_tile.cuh", _TILE, "      ring.acquire(cur);\n",
         "      const long long w0 = clock64();\n      ring.acquire(cur);\n"
         "      mgn_twait(clock64() - w0, me.tid == 0, blockIdx.x);\n"),
        _STAMP_IO],
}
VARIANTS = ("full", "ring_once", "one_partial", "stamped")

# --- the K2 on K4's EdgeBlock feed (11b02ae) ---
_BLOCK = "struct EdgeBlock {"
_PARENT_FORWARD = "edge_mlp_forward(EdgeBlock<T, L>& b,"
_PARENT_START = ("  // the round's edge stream: W0's e rows, then each hidden layer\n"
                 "  mgn::EdgeBlock<T, L> b(smem, wstream, p.n_layers, e, senders, receivers, "
                 "n_edges);\n")
_PARENT_EPILOGUE = ("  // LayerNorm's affine step, rounded to T; msg = that * edge_valid; "
                    "e += msg\n")
_PARENT_END = ("      Pair<T>::store(e + off, e0 + m0, e1 + m1);  // rounded to T by the store\n"
               "    }\n  }\n}\n")
_PARENT_DECL = (
    "namespace mgn {\n\n"
    "__device__ long long mgn_stamps[8192 * 10];\n"
    "__device__ __forceinline__ void mgn_stamp(int k) {\n"
    "  if (threadIdx.x == 0) mgn_stamps[blockIdx.x * 10 + k] = clock64();\n"
    "}\n"
    "__device__ __forceinline__ void mgn_gtime(int k) {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  if (threadIdx.x == 0) mgn_stamps[blockIdx.x * 10 + k] = static_cast<long long>(t);\n"
    "}\n\n")
# first in every parent_* variant: K2's kernel must construct an EdgeBlock
_ON_BLOCK = ("fused_round.cu", _KERNEL, _PARENT_START, _PARENT_START)
PATCHES.update({
    "parent_ring_once": [
        _ON_BLOCK,
        ("edge_tile.cuh", _BLOCK, "    if (next < total && me.tid == 0)",
         "    if (next < total && next < S && me.tid == 0)"),
        ("edge_tile.cuh", _BLOCK, "      mbar_wait(&bar[cur % S], (cur / S) & 1);",
         "      if (cur < S) mbar_wait(&bar[cur % S], (cur / S) & 1);")],
    "parent_no_gather": [
        _ON_BLOCK,
        ("edge_tile.cuh", _BLOCK,
         "      cp_async16(As + r * C::PA + col, e + static_cast<size_t>(s < 0 ? 0 : s) * L + "
         "col, s >= 0);",
         "      (void)r; (void)col; (void)s;")],
    "parent_no_pq": [
        _ON_BLOCK,
        ("edge_tile.cuh", _PARENT_FORWARD, "    if (s < 0) continue;\n    const float* ps",
         "    if (s < 0 || s >= 0) continue;\n    const float* ps")],
    "parent_no_ln": [
        _ON_BLOCK,
        ("edge_tile.cuh", _PARENT_FORWARD, "  row_sums<T, L, 1>(s, b.red, b.me);\n", ""),
        ("edge_tile.cuh", _PARENT_FORWARD, "  row_sums<T, L, 1>(d, b.red, b.me);\n", "")],
    "parent_no_epilogue": [
        _ON_BLOCK,
        ("fused_round.cu", _KERNEL, _PARENT_EPILOGUE,
         "  {\n    float z = 0.f;\n"
         "    for (int j = 0; j < NI; ++j)\n      for (int k = 0; k < 4; ++k) z += acc[j][k];\n"
         "    if (n_edges < 0) msg[me.tid] = mgn::from_f<T>(z);\n    return;\n  }\n"
         + _PARENT_EPILOGUE)],
    "parent_stamped": [
        _ON_BLOCK,
        ("edge_tile.cuh", None, "namespace mgn {\n\n", _PARENT_DECL),
        ("fused_round.cu", _KERNEL, _PARENT_START,
         "  mgn::mgn_gtime(8);\n  mgn::mgn_stamp(0);\n" + _PARENT_START
         + "  mgn::mgn_stamp(1);\n"),
        ("edge_tile.cuh", _PARENT_FORWARD, "  b.gather_e();\n  b.product(acc);\n",
         "  b.gather_e();\n  mgn_stamp(2);\n  b.product(acc);\n  mgn_stamp(3);\n"),
        ("edge_tile.cuh", _PARENT_FORWARD,
         "  add_bias<T, L>(acc, static_cast<const T*>(p.b[0]), b.me);\n",
         "  mgn_stamp(4);\n  add_bias<T, L>(acc, static_cast<const T*>(p.b[0]), b.me);\n"),
        ("edge_tile.cuh", _PARENT_FORWARD,
         "  // LayerNorm statistics (f32, two passes as the plain version) over the\n",
         "  mgn_stamp(5);\n"),
        ("edge_tile.cuh", _PARENT_FORWARD, _LN_END, _LN_END[:-2] + "\n  mgn_stamp(6);\n}\n"),
        ("fused_round.cu", _KERNEL, _PARENT_END,
         _PARENT_END[:-2] + "  __syncthreads();\n  mgn::mgn_stamp(7);\n  mgn::mgn_gtime(9);\n}\n"),
        _STAMP_IO],
})
PARENT_VARIANTS = tuple(v for v in PATCHES if v.startswith("parent_"))
_PHASES = ("indices", "gather_e", "product_1", "pq", "products_2_3", "layernorm", "epilogue")


def _definition(text: str, target: str) -> Tuple[int, int]:
    """The span of ``text`` that defines ``target``: from the line that
    holds it to the line that closes it (the next one that starts with
    ``}``)."""
    if text.count(target) != 1:
        raise ValueError(f"target {target!r} found {text.count(target)} times")
    start = text.rfind("\n", 0, text.index(target)) + 1
    close = text.index("\n}", start) + 1
    return start, text.index("\n", close) + 1


def patched(src: Dict[str, str], variant: str) -> Dict[str, str]:
    """The sources ``src`` (file name -> text) with ``variant``'s patches;
    raises where an anchor does not occur exactly once in its file, or lies
    outside the definition its patch targets."""
    out = dict(src)
    for name, target, old, new in PATCHES[variant]:
        text = out[name]
        n = text.count(old)
        if n != 1:
            raise ValueError(f"{variant}: anchor found {n} times in {name}: {old[:60]!r}")
        at = text.index(old)
        if target is not None:
            start, end = _definition(text, target)
            if not start <= at < at + len(old) <= end:
                raise ValueError(f"{variant}: anchor {old[:60]!r} lies outside {target!r}")
        out[name] = text[:at] + new + text[at + len(old):]
    return out


def sources(csrc: str = _CSRC) -> Dict[str, str]:
    """K2's library sources under ``csrc``: ``fused_round.cu`` and the
    headers it includes."""
    from mgn_tpu_torch.ops import _build as B

    src = {}
    for n in ("fused_round.cu", *B.LIBRARIES["fused_round"][1]):
        with open(os.path.join(csrc, n)) as fh:
            src[n] = fh.read()
    return src


def _build(csrc: str, variants: List[str], work: str) -> Dict[str, ctypes.CDLL]:
    from mgn_tpu_torch.ops import _build as B

    src = sources(csrc)
    running = []
    for v in variants:
        d = os.path.join(work, v)
        os.makedirs(d)
        for n, text in patched(src, v).items():
            with open(os.path.join(d, n), "w") as fh:
                fh.write(text)
        so = os.path.join(d, f"libk2_{v}.so")
        cmd = [B._nvcc(), *B._FLAGS, "-o", so, os.path.join(d, "fused_round.cu")]
        running.append((v, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for v, so, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        for line in log.splitlines():  # serialised wgmma, spills
            if "Performance Loss" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"{v}: {line.strip()[:160]}", flush=True)
        lib = ctypes.CDLL(so)
        lib.mgn_edge_round.argtypes = B._SIGNATURES["fused_round"]["mgn_edge_round"]
        lib.mgn_edge_round.restype = ctypes.c_int
        libs[v] = lib
    return libs


def _kernel_ms(fn, iters: int) -> float:
    """Mean device duration (ms) of the kernels named ``edge_round_kernel``
    that ``iters`` calls of ``fn`` ran (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    d = [ev.time_range.elapsed_us() for ev in prof.events()
         if ev.device_type == torch.autograd.DeviceType.CUDA and "edge_round_kernel" in ev.name]
    if len(d) < iters // 2:
        raise RuntimeError(f"the profiler saw {len(d)} K2 kernels of {iters} calls")
    return sum(d) / len(d) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=_CSRC, help="the kernel sources to copy")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, of " + ", ".join(PATCHES))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_split: needs a CUDA device")
    from mgn_tpu_torch import MGNConfig, init_mgn
    from mgn_tpu_torch.core.graph import build_template
    from mgn_tpu_torch.data.synthetic import make_channel_mesh
    from mgn_tpu_torch.ops import fused as F

    variants = args.variants.split(",")
    work = tempfile.mkdtemp()
    try:
        libs = _build(args.csrc, variants, work)
        pos, cells, nt = make_channel_mesh(1900, seed=0)
        t = build_template(pos, nt, cells=cells).to("cuda")
        cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=128,
                        hidden_layers=2, message_passing_steps=1)
        proc = init_mgn(cfg, torch.Generator().manual_seed(3), device="cuda")["processor"]
        gen = torch.Generator(device="cuda").manual_seed(2)
        res = {"card": card(), "csrc": os.path.relpath(args.csrc), "e_pad": t.num_edges,
               "n_pad": t.num_nodes}
        for dtype in (torch.float32, torch.bfloat16):
            ev = t.edge_mask.to(dtype)[:, None].contiguous()
            v0 = torch.randn((t.num_nodes, 128), generator=gen, device="cuda").to(dtype)
            e0 = (torch.randn((t.num_edges, 128), generator=gen, device="cuda").to(dtype)
                  * ev).contiguous()
            em0 = F.round_params(F.cast_mlp(proc["edge_mlp"], dtype), 0)
            ws = F.weight_streams(F.cast_mlp(proc["edge_mlp"], dtype))[0][0]
            p, q = F.edge_project_plain(v0, em0)
            params = F._round_struct(em0, dtype, e0.device, 3, 128)
            e, msg = e0.clone(), torch.empty_like(e0)
            stream = torch.cuda.current_stream().cuda_stream

            def call(lib):
                rc = lib.mgn_edge_round(F._DTYPE_CODES[dtype], 128, e.data_ptr(),
                                        msg.data_ptr(), p.data_ptr(), q.data_ptr(),
                                        t.senders.data_ptr(), t.receivers.data_ptr(),
                                        ev.data_ptr(), t.num_edges, ctypes.byref(params),
                                        ws.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(f"edge_round: CUDA error {rc}")

            r = {}
            for v, lib in libs.items():
                if hasattr(lib, "mgn_edge_round_init"):  # the shared memory, set once
                    lib.mgn_edge_round_init.restype = ctypes.c_int
                    if lib.mgn_edge_round_init() != 0:
                        raise RuntimeError(f"{v}: mgn_edge_round_init failed")
                r[v] = _kernel_ms(lambda: call(lib), args.iters)
            for name in ("stamped", "parent_stamped"):
                if name not in libs:
                    continue
                lib = libs[name]
                lib.mgn_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.mgn_write_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
                blocks = -(-t.num_edges // 64)
                stride = _STAMPS if name == "stamped" else _PARENT_STAMPS
                host = np.zeros(blocks * stride, dtype=np.int64)
                phases, waits = [], []
                for _ in range(20):
                    host[:] = 0
                    if lib.mgn_write_stamps(host.ctypes.data, host.size) != 0:
                        raise RuntimeError("clearing the stamps failed")
                    call(lib)
                    torch.cuda.synchronize()
                    if lib.mgn_read_stamps(host.ctypes.data, host.size) != 0:
                        raise RuntimeError("reading the stamps failed")
                    s = host.reshape(blocks, stride).astype(np.float64)
                    ns_per_clk = (s[:, 9] - s[:, 8]) / np.maximum(s[:, 7] - s[:, 0], 1)
                    phases.append(np.diff(s[:, :8], axis=1) * ns_per_clk[:, None] / 1e3)
                    if stride == _STAMPS:  # the tile's waits for its chunks
                        waits.append(s[:, 10] * ns_per_clk / 1e3)
                    span = (s[:, 9].max() - s[:, 8].min()) / 1e3
                ph = np.concatenate(phases)
                if waits:
                    r[f"{name}_chunk_wait_us"] = float(np.concatenate(waits).mean())
                r[f"{name}_us"] = {k: float(x) for k, x in zip(_PHASES, ph.mean(axis=0))}
                r[f"{name}_block_us"] = float(ph.sum(axis=1).mean())
                r[f"{name}_max_block_us"] = float(ph.sum(axis=1).max())
                r[f"{name}_launch_span_us"] = float(span)
            res[str(dtype)] = r
        line = "k2-split: " + json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
