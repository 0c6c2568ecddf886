"""Synthetic inputs (tests, chip_smoke.py): cylinder-flow-shaped channel
meshes and FlagSimple-shaped cloth sheets.

The port's copy of the numpy generators of ``mgn_tpu/data/synthetic.py``:
the same seeds give the same arrays as the JAX package.  The JAX package's
dataset writer writes HDF5 through ``h5py``; the port's
:func:`write_synthetic_tfrecord_dataset` writes the same trajectories
(same meshes, same seeds) as TFRecord instead, which the GPU machine reads
without ``h5py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
from scipy.spatial import Delaunay

from mgn_tpu_torch.data.tfrecord_writer import write_tfrecord_dataset

__all__ = ["make_channel_mesh", "make_trajectory", "synthetic_meta",
           "write_synthetic_tfrecord_dataset", "make_flag_mesh", "make_flag_trajectory",
           "flag_meta"]


def make_channel_mesh(num_nodes: int, seed: int = 0):
    """Random triangulated unit channel [0,2]x[0,1] with boundary node types.

    Returns (mesh_pos (N,2) f32, cells (C,3) i32, node_type (N,) i32):
    type 1 = inflow (x==0), 5 = outflow (x==2), 6 = wall (y boundary),
    0 = interior fluid.
    """
    rng = np.random.default_rng(seed)
    n_side = max(4, int(np.sqrt(num_nodes / 2)))
    # structured boundary + jittered interior for a valid triangulation
    xs = np.linspace(0, 2, 2 * n_side)
    ys = np.linspace(0, 1, n_side)
    bound = np.concatenate([
        np.stack([xs, np.zeros_like(xs)], 1),
        np.stack([xs, np.ones_like(xs)], 1),
        np.stack([np.zeros(n_side - 2), ys[1:-1]], 1),
        np.stack([np.full(n_side - 2, 2.0), ys[1:-1]], 1),
    ])
    n_int = max(0, num_nodes - len(bound))
    interior = rng.random((n_int, 2)) * [1.96, 0.96] + [0.02, 0.02]
    pos = np.concatenate([bound, interior], 0).astype(np.float32)
    tri = Delaunay(pos)
    cells = tri.simplices.astype(np.int32)
    node_type = np.zeros(len(pos), np.int32)
    node_type[np.abs(pos[:, 1]) < 1e-6] = 6
    node_type[np.abs(pos[:, 1] - 1) < 1e-6] = 6
    node_type[np.abs(pos[:, 0] - 2) < 1e-6] = 5
    node_type[np.abs(pos[:, 0]) < 1e-6] = 1
    return pos, cells, node_type


def make_trajectory(
    mesh_pos: np.ndarray, node_type: np.ndarray, tl: int, dt: float, seed: int = 0,
    speed: Optional[float] = None,
) -> np.ndarray:
    """Smooth traveling-wave velocity field (T, N, 2), zero on walls.

    With the default per-trajectory random ``speed`` the dynamics are not
    Markovian in the velocity state; pass a fixed ``speed`` where the field
    must be exactly learnable from the state.
    """
    rng = np.random.default_rng(seed)
    phase = rng.random() * 2 * np.pi
    if speed is None:
        speed = 0.5 + rng.random()
    x, y = mesh_pos[:, 0], mesh_pos[:, 1]
    t = np.arange(tl, dtype=np.float32)[:, None] * dt
    profile = 4 * y * (1 - y)  # parabolic channel profile
    u = profile[None, :] * (1.0 + 0.3 * np.sin(2 * np.pi * (x[None, :] - speed * t) + phase))
    v = 0.1 * profile[None, :] * np.cos(2 * np.pi * (x[None, :] - speed * t) + phase)
    vel = np.stack([u, v], axis=-1).astype(np.float32)
    vel[:, node_type == 6] = 0.0
    return vel


def synthetic_meta(tl: int, n_train: int, n_valid: int, dt: float = 0.01) -> Dict:
    """meta.json matching the cylinder_flow example schema."""
    return {
        "dt": dt,
        "trajectory_length": tl,
        "n_trajectories": n_train,
        "n_trajectories_valid": n_valid,
        "dims": 2,
        "feature_names": ["cells", "mesh_pos", "node_type", "velocity"],
        "target_features": ["velocity"],
        "features": {
            "cells": {"type": "static", "dim": 3, "shape": [1, -1, 3], "dtype": "int32"},
            "mesh_pos": {"type": "static", "dim": 2, "shape": [1, -1, 2],
                         "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "shape": [1, -1, 1],
                          "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 6},
            "velocity": {"type": "dynamic", "dim": 2, "shape": [tl, -1, 2],
                         "dtype": "float32"},
        },
    }


def write_synthetic_tfrecord_dataset(path: str, num_nodes: int = 256, tl: int = 50,
                                     n_train: int = 4, n_valid: int = 2, n_test: int = 2,
                                     dt: float = 0.01, seed: int = 0,
                                     speed: Optional[float] = None) -> Dict:
    """Write ``meta.json`` and ``train``/``valid``/``test.tfrecord`` of
    channel-flow trajectories on one mesh; returns the meta dict.  The
    trajectories are those ``mgn_tpu``'s ``write_synthetic_dataset`` writes
    to HDF5 for the same arguments (velocity seeds ``seed + 1000 + k``)."""
    meta = synthetic_meta(tl, n_train, n_valid, dt)
    pos, cells, node_type = make_channel_mesh(num_nodes, seed)
    splits, k = {}, 0
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        trajs = []
        for _ in range(n):
            trajs.append({"cells": cells[None], "mesh_pos": pos[None],
                          "node_type": node_type[None, :, None],
                          "velocity": make_trajectory(pos, node_type, tl, dt, seed + 1000 + k,
                                                      speed=speed)})
            k += 1
        splits[split] = trajs
    os.makedirs(path, exist_ok=True)
    write_tfrecord_dataset(path, meta, splits)
    return meta


# --- FlagSimple (cloth) -------------------------------------------------------
# The JAX package's HDF5 flag dataset writer is not ported (no h5py on the GPU
# machine); a TFRecord writer comes with cloth training.

def make_flag_mesh(nx: int = 8, ny: int = 6):
    """Triangulated rectangular cloth sheet.

    Returns (mesh_pos (N,2) reference coords, cells (C,3), node_type (N,)):
    type 3 = HANDLE (fixed pole edge x=0), 0 = NORMAL cloth.
    """
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 0.6, ny), indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    idx = np.arange(nx * ny).reshape(nx, ny)
    c = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            c.append([idx[i, j], idx[i + 1, j], idx[i, j + 1]])
            c.append([idx[i + 1, j], idx[i + 1, j + 1], idx[i, j + 1]])
    cells = np.asarray(c, np.int32)
    node_type = np.zeros(nx * ny, np.int32)
    node_type[idx[0, :]] = 3  # handle: attached edge
    return pos, cells, node_type


def make_flag_trajectory(mesh_pos: np.ndarray, node_type: np.ndarray, tl: int, dt: float,
                         seed: int = 0, amp: Optional[float] = None,
                         freq: Optional[float] = None,
                         phase: Optional[float] = None) -> np.ndarray:
    """Waving-cloth world positions (T, N, 3): reference sheet + traveling
    transverse wave, handle pinned.  ``amp``, ``freq`` and ``phase`` default
    to per-seed random draws (with a fixed ``freq`` the field is exactly
    harmonic: acc = -(2 pi freq)^2 * displacement)."""
    rng = np.random.default_rng(seed)
    if amp is None:
        amp = 0.1 + 0.1 * rng.random()
    if freq is None:
        freq = 2.0 + 2.0 * rng.random()
    if phase is None:
        phase = 2 * np.pi * rng.random()
    x, y = mesh_pos[:, 0], mesh_pos[:, 1]
    t = np.arange(tl, dtype=np.float32)[:, None] * dt
    z = amp * x[None, :] * np.sin(2 * np.pi * (2 * x[None, :] - freq * t) + phase)
    wx = x[None, :] * (1 - 0.1 * amp * np.sin(2 * np.pi * freq * t + phase))
    world = np.stack([wx, np.broadcast_to(y[None, :], wx.shape), z], -1)
    world[:, node_type == 3, 2] = 0.0
    return world.astype(np.float32)


def flag_meta(tl: int, n_train: int, n_valid: int, dt: float = 0.02) -> Dict:
    """meta.json of the FlagSimple cloth family: 2-D reference mesh, 3-D
    world positions, dynamic world edges (radius, capacity per node)."""
    return {
        "dt": dt,
        "trajectory_length": tl,
        "n_trajectories": n_train,
        "n_trajectories_valid": n_valid,
        "dims": 2,  # reference (mesh) space is 2-D; world space is 3-D
        "world_dim": 3,
        "world_edges": {"radius": 0.05, "capacity_per_node": 4},
        "feature_names": ["cells", "mesh_pos", "node_type", "world_pos"],
        "target_features": ["world_pos"],
        "features": {
            "cells": {"type": "static", "dim": 3, "shape": [1, -1, 3], "dtype": "int32"},
            "mesh_pos": {"type": "static", "dim": 2, "shape": [1, -1, 2],
                         "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "shape": [1, -1, 1],
                          "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 6},
            "world_pos": {"type": "dynamic", "dim": 3, "shape": [tl, -1, 3],
                          "dtype": "float32"},
        },
    }
