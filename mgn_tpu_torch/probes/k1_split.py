"""Where K1's time goes: one kernel, inputs that differ only in their trash row.

K1 (``csr_segment_sum``, ``ops/csrc/csr_segment.cu``) sums each CSR row of
edge rows into its node row, and K1-perm does the same through the
template's sender permutation.  The padding contract sends every dead edge
to node ``N_pad - 1``, as sender and as receiver, so that one row is by far
the longest: 222 entries at the cylinder (the longest real row has 11), 966
at the flag (6).  A profiler sees one kernel, so this probe times it on
inputs that tell the trash row's share apart.  It builds a tree's
``csr_segment.cu`` (``--csrc``, by default this tree's) with ``nvcc`` as it
is, and times K1 and K1-perm, f32 and bf16 at latent 128, in profiler device
ms over ``--iters`` launches each, at:

- ``cylinder``: the cylinder's template as built (N_pad 1,920, E_pad 11,264);
- ``emptied``: the same with the trash row emptied (``row_offsets[N_pad] =
  row_offsets[N_pad - 1]``, likewise ``sender_offsets``), so that the dead
  rows are never read;
- ``flag``: the 50 x 32 flag's template (N_pad 1,664, E_pad 10,240).

Only the inputs vary.  A tree whose ``mgn_csr_segment_sum`` takes the
fixed order's chunk length (an ``int chunk`` argument, since the chunked
design) is passed the wrapper's ``CHUNK``.  Run on the card from the
repository root::

    python -m mgn_tpu_torch.probes.k1_split [--csrc DIR] [--out FILE]

Prints one JSON line, ``k1-split:``, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Tuple

import torch

from mgn_tpu_torch.probes import card

__all__ = ["INPUTS", "emptied", "templates", "main"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "ops", "csrc")
INPUTS = ("cylinder", "emptied", "flag")
_LATENT = 128


def emptied(offsets: torch.Tensor) -> torch.Tensor:
    """``offsets`` with its last row emptied: ``offsets[-1] = offsets[-2]``."""
    out = offsets.clone()
    out[-1] = out[-2]
    return out


def templates(device: str = "cpu") -> Dict[str, dict]:
    """The probe's inputs: name -> ``{"n": N_pad, "e": E_pad, "k1": offsets,
    "perm": (sender_perm, sender_offsets)}``, int32 on ``device``."""
    from mgn_tpu_torch.core.graph import build_template
    from mgn_tpu_torch.data.synthetic import make_channel_mesh, make_flag_mesh

    pos, cells, nt = make_channel_mesh(1900, seed=0)
    cyl = build_template(pos, nt, cells=cells)
    pos, cells, nt = make_flag_mesh(50, 32)
    flag = build_template(pos, nt, cells=cells)
    out = {}
    for name, t, cut in (("cylinder", cyl, False), ("emptied", cyl, True),
                         ("flag", flag, False)):
        row, send = t.row_offsets, t.sender_offsets
        if cut:
            row, send = emptied(row), emptied(send)
        out[name] = {"n": t.num_nodes, "e": t.num_edges, "k1": row.to(device),
                     "perm": (t.sender_perm.to(device), send.to(device))}
    return out


def _row_stats(offsets: torch.Tensor) -> Tuple[int, int]:
    """(the trash row's length, the longest other row's)."""
    deg = torch.diff(offsets.long())
    return int(deg[-1]), int(deg[:-1].max())


def _build(csrc: str, work: str) -> ctypes.CDLL:
    """``csrc/csr_segment.cu`` built as it is; prints each kernel's
    registers and any spills."""
    from mgn_tpu_torch.ops import _build as B

    so = os.path.join(work, "libk1.so")
    cmd = [B._nvcc(), *B._FLAGS, "-o", so, os.path.join(csrc, "csr_segment.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    kernel = ""
    for line in proc.stdout.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1][-40:]
        elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
            print(f"{kernel}: {line.split(':', 1)[-1].strip()[:100]}", flush=True)
    return ctypes.CDLL(so)


def _takes_chunk(csrc: str) -> bool:
    """Whether the tree's ``mgn_csr_segment_sum`` takes a chunk length."""
    with open(os.path.join(csrc, "csr_segment.cu")) as fh:
        src = fh.read()
    sig = re.search(r"int mgn_csr_segment_sum\(([^)]*)\)", src)
    if sig is None:
        raise RuntimeError(f"{csrc}/csr_segment.cu defines no mgn_csr_segment_sum")
    return re.search(r"\bint chunk\b", sig.group(1)) is not None


def _kernel_ms(fn, iters: int) -> float:
    """Mean device duration (ms) of the kernels named ``csr_segment_sum_kernel``
    that ``iters`` calls of ``fn`` ran (torch.profiler).  The profiler drops
    events now and then: a profile that saw fewer than half the kernels is
    taken again, three in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    seen = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        d = [ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and "csr_segment_sum_kernel" in ev.name]
        if len(d) >= iters // 2:
            return sum(d) / len(d) / 1e3
        seen.append(len(d))
    raise RuntimeError(f"the profiler saw {seen} K1 kernels of {iters} calls, three profiles")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=_CSRC, help="the kernel sources to build")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_split: needs a CUDA device")
    from mgn_tpu_torch.ops import csr_segment

    work = tempfile.mkdtemp()
    try:
        lib = _build(args.csrc, work)
        chunked = _takes_chunk(args.csrc)
        inputs = templates("cuda")
        res = {"card": card(), "csrc": os.path.relpath(args.csrc), "iters": args.iters,
               "chunk": csr_segment.CHUNK if chunked else None,
               "rows": {name: {"k1": _row_stats(x["k1"]), "perm": _row_stats(x["perm"][1])}
                        for name, x in inputs.items()}}
        gen = torch.Generator(device="cuda").manual_seed(1)
        stream = torch.cuda.current_stream().cuda_stream
        lib.mgn_csr_segment_sum.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * chunked + [ctypes.c_void_p])
        lib.mgn_csr_segment_sum.restype = ctypes.c_int
        for dtype in (torch.float32, torch.bfloat16):
            code = 0 if dtype == torch.float32 else 1
            for name, x in inputs.items():
                data = torch.randn((x["e"], _LATENT), generator=gen, device="cuda").to(dtype)
                out = torch.empty((x["n"], _LATENT), device="cuda")
                for form, (perm, offsets) in (("k1", (None, x["k1"])), ("perm", x["perm"])):
                    call_args = [data.data_ptr(), code, offsets.data_ptr(),
                                 None if perm is None else perm.data_ptr(), out.data_ptr(),
                                 x["n"], _LATENT]
                    call_args += [csr_segment.CHUNK] * chunked + [stream]

                    def call():
                        rc = lib.mgn_csr_segment_sum(*call_args)
                        if rc != 0:
                            raise RuntimeError(f"csr_segment_sum: CUDA error {rc}")

                    res[f"{name} {form} {str(dtype)[6:]}"] = _kernel_ms(call, args.iters)
        line = "k1-split: " + json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
