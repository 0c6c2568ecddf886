"""Build and load the port's CUDA kernels.

Each library under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The build happens at first use
and lands in ``ops/build/`` (listed in ``.gitignore``); the file name carries
a hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  :func:`build_all` starts one ``nvcc`` per library,
all at once, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["LIBRARIES", "build_all", "library", "check"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "build")

# library name -> (sources compiled, headers they include)
LIBRARIES: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "csr_segment": (("csr_segment.cu",), ()),
    "fused_round": (("fused_round.cu",), ("edge_tile.cuh", "node_tile.cuh", "proj_tile.cuh",
                                          "mlp_tile.cuh", "mma_tile.cuh")),
    "fused_round_bwd": (("fused_round_bwd.cu",), ("edge_tile.cuh", "node_tile.cuh",
                                                  "proj_tile.cuh", "mlp_tile.cuh",
                                                  "mma_tile.cuh")),
    "wgrad": (("wgrad.cu",), ("mma_tile.cuh",)),
    "onehot_probe": (("onehot_probe.cu",), ("mma_tile.cuh",)),
}

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int


class MlpParams(ctypes.Structure):
    """One round of one processor MLP; mirrors ``mgn::MlpParams`` in
    ``csrc/mlp_tile.cuh``."""

    _fields_ = [("w", _P * 8), ("b", _P * 8), ("ln_scale", _P),
                ("ln_bias", _P), ("n_layers", _I)]


class BwdParams(ctypes.Structure):
    """The per-layer outputs of K4/K5 for one MLP round; mirrors
    ``BwdParams`` in ``csrc/fused_round_bwd.cu``."""

    _fields_ = [("dh", _P * 8), ("post", _P * 8), ("ln_part", _P)]


class WgradProduct(ctypes.Structure):
    """One product of a K6 group; mirrors ``mgn::WgradProduct`` in
    ``csrc/wgrad.cu``."""

    _fields_ = [("x", _P * 3), ("idx", _P * 3), ("dh", _P), ("dw", _P), ("db", _P * 2),
                ("scratch0", ctypes.c_longlong),
                *[(n, _I) for n in ("parts", "rows", "a_dim", "b_dim", "b_split", "dh_f32",
                                    "tiles_a", "tiles_b", "splits", "rows_per_block",
                                    "block0", "counter0")]]


class WgradGroup(ctypes.Structure):
    """Every product of one K6 launch; mirrors ``mgn::WgradGroup``."""

    _fields_ = [("p", WgradProduct * 12), ("n_products", _I), ("n_blocks", _I)]


_SIGNATURES = {
    "csr_segment": {
        "mgn_csr_segment_sum": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
    },
    "fused_round": {
        "mgn_edge_round": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                           ctypes.POINTER(MlpParams), _P, _P],
        "mgn_edge_round_init": [],
        "mgn_edge_round_plan": [_I, _I, _I, ctypes.POINTER(_I)],
        "mgn_edge_project_init": [],
        "mgn_edge_project": [_I, _I, _P, _P, _P, _I, _P, _P],
        "mgn_node_round": [_I, _I, _P, _P, _P, _I, ctypes.POINTER(MlpParams), _P, _P],
        "mgn_weight_streams": [_I, _I, ctypes.POINTER(MlpParams), ctypes.POINTER(MlpParams), _I,
                               _I, _P, _P, _P, _P],
    },
    "fused_round_bwd": {
        "mgn_edge_round_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               ctypes.POINTER(MlpParams), ctypes.POINTER(BwdParams), _P, _P],
        "mgn_node_round_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _I,
                               ctypes.POINTER(MlpParams), ctypes.POINTER(BwdParams), _P, _P],
        "mgn_first_layer_adjoint_init": [],
        "mgn_first_layer_adjoint": [_I, _I, _P, _P, _P, _I, _P, _P],
    },
    "wgrad": {
        "mgn_wgrad_init": [],
        "mgn_wgrad_max_blocks": [_I, _I, ctypes.POINTER(_I)],
        "mgn_wgrad_group": [_I, _I, ctypes.POINTER(WgradGroup), _P, ctypes.c_longlong, _P, _I,
                            _P],
    },
    "onehot_probe": {
        "mgn_window_gather": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "mgn_onehot_pair": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): "
                       "the port's kernels are built from source on the GPU machine")


def _so_path(name: str) -> str:
    sources, headers = LIBRARIES[name]
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in sources + headers:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile every library that is missing, one ``nvcc`` each, in parallel.

    Returns ``{name: {"seconds": float, "log": str, "cached": bool}}``;
    raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = list(LIBRARIES) if names is None else list(names)
    os.makedirs(_BUILD, exist_ok=True)
    info: Dict[str, dict] = {}
    running = []
    for name in names:
        so = _so_path(name)
        if os.path.isfile(so):
            info[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_FLAGS, "-o", tmp,
               *[os.path.join(_CSRC, s) for s in LIBRARIES[name][0]]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((name, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        info[name] = {"seconds": seconds, "log": log, "cached": False}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return info


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    build_all([name])
    lib = ctypes.CDLL(_so_path(name))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    lib.mgn_cuda_error_string.argtypes = [_I]
    lib.mgn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.mgn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
