"""ctypes bindings to the native (C++) graph builder: the port's copy of
``mgn_tpu/ops/native.py``.

The library is compiled from the repository's ``native/graph_builder.cpp``
at first use, with ``g++ -O3 -shared -fPIC`` (no ``-march=native``, so a
library built on one host runs on another), into the port's build directory
``mgn_tpu_torch/ops/build/`` (listed in ``.gitignore``).  The file name
carries a hash of the source and the flags, so an edited source is rebuilt;
nothing is written under ``native/``.

This is host code, so it keeps the reference's semantics: where the library
loads, :func:`mgn_tpu_torch.core.graph.build_template` takes its edges from
:func:`cells_to_edges_native` (sorted by receiver, then sender); where it does
not (no compiler, a failed build), the numpy route, which sorts to the same
order, so a template's bits do not depend on the host.  :func:`route` says
which one ran.  :func:`csr_offsets_native` and :func:`edge_features_native`
complete the copy of the JAX module; ``build_template`` keeps the numpy
offsets and features, which have the same bits, on both routes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_library", "available", "route", "cells_to_edges_native",
           "csr_offsets_native", "edge_features_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "graph_builder.cpp")
_BUILD = os.path.join(_HERE, "build")
_FLAGS = ["-O3", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(_BUILD, f"libmgn_native-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, "-o", tmp, _SOURCE], check=True, capture_output=True,
                   timeout=120)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded library, built first where it is missing and ``build``;
    None where it cannot be built or loaded.  Tried once a process."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = _so_path()
        if not os.path.isfile(so) and build:
            _build(so)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError):
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mgn_cells_to_edges.restype = ctypes.c_int64
    lib.mgn_cells_to_edges.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p]
    lib.mgn_csr_offsets.restype = None
    lib.mgn_csr_offsets.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
    lib.mgn_edge_features.restype = None
    lib.mgn_edge_features.argtypes = [f32p, ctypes.c_int32, i32p, i32p, ctypes.c_int64, f32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def route() -> str:
    """``"native"`` where the library loads, else ``"numpy"``: the route
    :func:`~mgn_tpu_torch.core.graph.build_template` builds edges by."""
    return "native" if available() else "numpy"


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def cells_to_edges_native(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cells ``(C, K)`` -> unique bidirectional edges ``(senders,
    receivers)``, sorted by (receiver, sender); self-loops kept once."""
    lib = load_library()
    assert lib is not None
    cells = np.ascontiguousarray(cells, np.int32)
    ncells, k = cells.shape
    cap = ncells * k * (k - 1)
    senders = np.empty(cap, np.int32)
    receivers = np.empty(cap, np.int32)
    e = lib.mgn_cells_to_edges(_ptr(cells, ctypes.c_int32), ncells, k,
                               _ptr(senders, ctypes.c_int32), _ptr(receivers, ctypes.c_int32))
    return senders[:e].copy(), receivers[:e].copy()


def csr_offsets_native(receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """Row offsets ``(num_nodes + 1,)`` of receiver-sorted edges."""
    lib = load_library()
    assert lib is not None
    receivers = np.ascontiguousarray(receivers, np.int32)
    out = np.empty(num_nodes + 1, np.int32)
    lib.mgn_csr_offsets(_ptr(receivers, ctypes.c_int32), len(receivers), num_nodes,
                        _ptr(out, ctypes.c_int32))
    return out


def edge_features_native(mesh_pos: np.ndarray, senders: np.ndarray,
                         receivers: np.ndarray) -> np.ndarray:
    """Mesh-space edge features ``[pos_s - pos_r, |pos_s - pos_r|]`` ``(E, D+1)``."""
    lib = load_library()
    assert lib is not None
    mesh_pos = np.ascontiguousarray(mesh_pos, np.float32)
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = len(senders)
    dim = mesh_pos.shape[1]
    out = np.empty((e, dim + 1), np.float32)
    lib.mgn_edge_features(_ptr(mesh_pos, ctypes.c_float), dim, _ptr(senders, ctypes.c_int32),
                          _ptr(receivers, ctypes.c_int32), e, _ptr(out, ctypes.c_float))
    return out
