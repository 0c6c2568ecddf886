"""Synthetic inputs (tests, chip_smoke.py): cylinder-flow-shaped channel
meshes, FlagSimple-shaped cloth sheets, Airfoil-shaped multi-target flows
and DeformingPlate-shaped 3-D grid solids.

The port's copy of the numpy generators of ``mgn_tpu/data/synthetic.py``:
the same seeds give the same arrays as the JAX package.  The JAX package's
dataset writers write HDF5 through ``h5py``; the port's
:func:`write_synthetic_tfrecord_dataset`, :func:`write_flag_tfrecord_dataset`,
:func:`write_airfoil_tfrecord_dataset` and :func:`write_plate_tfrecord_dataset`
write the same trajectories (same meshes, same seeds) as TFRecord instead,
which the GPU machine reads without ``h5py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
from scipy.spatial import Delaunay

from mgn_tpu_torch.core.graph import grid_edges
from mgn_tpu_torch.data.tfrecord_writer import write_tfrecord_dataset

__all__ = ["make_channel_mesh", "make_trajectory", "synthetic_meta",
           "write_synthetic_tfrecord_dataset", "make_flag_mesh", "make_flag_trajectory",
           "flag_meta", "write_flag_tfrecord_dataset", "airfoil_meta",
           "write_airfoil_tfrecord_dataset", "plate_meta", "plate_grid",
           "write_plate_tfrecord_dataset"]


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


def write_flag_tfrecord_dataset(path: str, nx: int = 8, ny: int = 6, tl: int = 30,
                                n_train: int = 2, n_valid: int = 1, n_test: int = 1,
                                dt: float = 0.02, seed: int = 0, amp: Optional[float] = None,
                                freq: Optional[float] = None) -> Dict:
    """Write ``meta.json`` and ``train``/``valid``/``test.tfrecord`` of
    FlagSimple-shaped cloth trajectories on one ``nx`` x ``ny`` sheet;
    returns the meta dict.  The trajectories are those ``mgn_tpu``'s
    ``write_flag_dataset`` writes to HDF5 for the same arguments (seeds
    ``seed + 100 + k``)."""
    meta = flag_meta(tl, n_train, n_valid, dt)
    pos, cells, node_type = make_flag_mesh(nx, ny)
    splits, k = {}, 0
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        trajs = []
        for _ in range(n):
            trajs.append({"cells": cells[None], "mesh_pos": pos[None],
                          "node_type": node_type[None, :, None],
                          "world_pos": make_flag_trajectory(pos, node_type, tl, dt,
                                                            seed + 100 + k, amp=amp,
                                                            freq=freq)})
            k += 1
        splits[split] = trajs
    os.makedirs(path, exist_ok=True)
    write_tfrecord_dataset(path, meta, splits)
    return meta


# --- Airfoil (compressible flow) ---------------------------------------------

def airfoil_meta(tl: int, n_train: int, n_valid: int, dt: float = 0.008) -> Dict:
    """meta.json of the Airfoil family: two targets, velocity (2) and
    density (1)."""
    return {
        "dt": dt,
        "trajectory_length": tl,
        "n_trajectories": n_train,
        "n_trajectories_valid": n_valid,
        "dims": 2,
        "feature_names": ["cells", "mesh_pos", "node_type", "velocity", "density"],
        "target_features": ["velocity", "density"],
        "features": {
            "cells": {"type": "static", "dim": 3, "shape": [1, -1, 3], "dtype": "int32"},
            "mesh_pos": {"type": "static", "dim": 2, "shape": [1, -1, 2],
                         "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "shape": [1, -1, 1],
                          "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 6},
            "velocity": {"type": "dynamic", "dim": 2, "shape": [tl, -1, 2],
                         "dtype": "float32"},
            "density": {"type": "dynamic", "dim": 1, "shape": [tl, -1, 1],
                        "dtype": "float32"},
        },
    }


def write_airfoil_tfrecord_dataset(path: str, num_nodes: int = 256, tl: int = 20,
                                   n_train: int = 2, n_valid: int = 1, n_test: int = 1,
                                   dt: float = 0.008, seed: int = 0,
                                   speed: Optional[float] = None) -> Dict:
    """Write ``meta.json`` and ``train``/``valid``/``test.tfrecord`` of
    Airfoil-shaped multi-target trajectories (velocity and a density
    ``1 + 0.1 |velocity|``) on one channel mesh; returns the meta dict.  The
    trajectories are those ``mgn_tpu``'s ``write_airfoil_dataset`` writes to
    HDF5 for the same arguments (velocity seeds ``seed + 300 + k``)."""
    meta = airfoil_meta(tl, n_train, n_valid, dt)
    pos, cells, node_type = make_channel_mesh(num_nodes, seed)
    splits, k = {}, 0
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        trajs = []
        for _ in range(n):
            vel = make_trajectory(pos, node_type, tl, dt, seed + 300 + k, speed=speed)
            density = (1.0 + 0.1 * np.linalg.norm(vel, axis=-1, keepdims=True)
                       ).astype(np.float32)
            trajs.append({"cells": cells[None], "mesh_pos": pos[None],
                          "node_type": node_type[None, :, None], "velocity": vel,
                          "density": density})
            k += 1
        splits[split] = trajs
    os.makedirs(path, exist_ok=True)
    write_tfrecord_dataset(path, meta, splits)
    return meta


# --- DeformingPlate (3-D quasi-static solid with stress head) ----------------

def plate_meta(tl: int, n_train: int, n_valid: int, dt: float = 1.0, dims=(4, 4, 3)) -> Dict:
    """meta.json of the DeformingPlate family in the TFRecord schema: a 3-D
    structured grid (``dims``, a list: three spatial dimensions), world
    positions and an ``absolute`` stress head.  The schema has no grid, so
    the grid's connectivity is a ``cells`` feature of width 2 (the undirected
    grid pairs, :func:`plate_grid`); both packages' readers turn such cells
    into the bidirectional grid edges."""
    return {
        "dt": dt,
        "trajectory_length": tl,
        "n_trajectories": n_train,
        "n_trajectories_valid": n_valid,
        "dims": [int(d) for d in dims],
        "feature_names": ["cells", "mesh_pos", "node_type", "world_pos", "stress"],
        "target_features": ["world_pos", "stress"],
        "features": {
            "cells": {"type": "static", "dim": 2, "shape": [1, -1, 2], "dtype": "int32"},
            "mesh_pos": {"type": "static", "dim": 3, "shape": [1, -1, 3],
                         "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "shape": [1, -1, 1], "dtype": "int32",
                          "onehot": True, "data_min": 0, "data_max": 6},
            "world_pos": {"type": "dynamic", "dim": 3, "shape": [tl, -1, 3],
                          "dtype": "float32"},
            # stress is a value head, not a derivative
            "stress": {"type": "dynamic", "dim": 1, "shape": [tl, -1, 1],
                       "dtype": "float32", "output_mode": "absolute"},
        },
    }


def plate_grid(dims) -> np.ndarray:
    """The undirected pairs ``(P, 2)`` (lower index first) of the grid edges
    the HDF5 reader synthesises for a grid meta (:func:`grid_edges`)."""
    s, r = grid_edges(dims)
    return np.stack([s, r], axis=1)[s <= r].astype(np.int32)


def write_plate_tfrecord_dataset(path: str, dims=(4, 4, 3), tl: int = 10, n_train: int = 2,
                                 n_valid: int = 1, n_test: int = 1, seed: int = 0,
                                 dt: float = 1.0, tau: float = 4.0) -> Dict:
    """Write ``meta.json`` (:func:`plate_meta`) and
    ``train``/``valid``/``test.tfrecord`` of DeformingPlate-shaped
    trajectories; returns the meta dict.  The trajectories are those
    ``mgn_tpu``'s ``write_plate_dataset`` writes to HDF5 for the same
    arguments: a 3-D grid in column-major node order, type 3 (held handle)
    on the top layer and 6 (clamped) on the bottom, each trajectory a random
    smooth displacement relaxing exponentially (time constant ``tau``)
    towards a fixed sag, and a stress of ``|disp - eq| + 0.5 |disp_z|``.
    The grid's connectivity is stored as ``cells`` of width 2
    (:func:`plate_grid`), the edges the HDF5 reader synthesises, so a
    TFRecord plate and an HDF5 plate give one graph."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    # column-major (Fortran) node order, as the JAX package's writer
    grid = np.stack(np.meshgrid(*[np.linspace(0, 1, d) for d in dims], indexing="ij"),
                    -1).reshape(-1, 3, order="F")
    pos = grid.astype(np.float32)
    node_type = np.zeros(n, np.int32)
    node_type[pos[:, 2] > 0.99] = 3  # top layer: held handle
    node_type[pos[:, 2] < 0.01] = 6  # bottom clamped
    free = node_type == 0
    meta = plate_meta(tl, n_train, n_valid, dt=dt, dims=dims)
    cells = plate_grid(dims)
    rng = np.random.default_rng(seed)
    # fixed equilibrium sag: interior bows toward -z, zero at held layers
    shape_fn = np.sin(np.pi * pos[:, 2]) * (1 - 0.4 * pos[:, 0]) * (1 - 0.2 * pos[:, 1])
    eq = np.zeros((n, 3), np.float32)
    eq[:, 2] = -0.15 * shape_fn
    eq[~free] = 0.0
    splits = {}
    for split, cnt in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        trajs = []
        for _ in range(cnt):
            # random smooth initial displacement (few low-frequency modes)
            r = rng.standard_normal(6) * 0.08
            disp0 = np.zeros((n, 3), np.float32)
            for ax in range(3):
                disp0[:, ax] = (r[ax] * np.sin(np.pi * pos[:, 2]) * np.sin(np.pi * pos[:, 0])
                                + r[3 + ax] * np.sin(np.pi * pos[:, 2])
                                * np.cos(np.pi * pos[:, 1])) * 0.5
            disp0[~free] = 0.0
            t = (np.arange(tl, dtype=np.float32) * dt)[:, None, None]
            disp = eq[None] + (disp0 - eq)[None] * np.exp(-t / tau)
            world = pos[None] + disp
            stress = np.linalg.norm(disp - eq[None], axis=-1) + 0.5 * np.abs(disp[..., 2])
            trajs.append({"cells": cells[None], "mesh_pos": pos[None],
                          "node_type": node_type[None, :, None],
                          "world_pos": world.astype(np.float32),
                          "stress": stress.astype(np.float32)[..., None]})
        splits[split] = trajs
    os.makedirs(path, exist_ok=True)
    write_tfrecord_dataset(path, meta, splits)
    return meta
