"""Incompressible Navier-Stokes vortex-shedding dataset generator: the
port's copy of ``mgn_tpu/data/ns.py``, writing TFRecord instead of HDF5.

* :func:`solve_ns_channel` — Chorin projection method on a uniform
  collocated grid: upwind-biased advection, explicit diffusion, immersed
  cylinder by direct forcing (velocity zeroed inside the mask), pressure
  Poisson with homogeneous Neumann walls solved exactly by DCT-II, advective
  outflow.  At Re ~ 100-200 and with a transverse seed perturbation the wake
  goes unstable and sheds a von Karman street within ~10 time units.
* :func:`make_cylinder_mesh` — triangulated channel mesh with a cylinder
  hole, DeepMind node types (1 inflow, 5 outflow, 6 wall and cylinder
  surface, 0 fluid).
* :func:`interp_grid_to_mesh` — bilinear interpolation of the grid solution
  onto the mesh nodes.
* :func:`write_ns_tfrecord_dataset` — meta.json and train/valid/test
  TFRecord files of vortex-shedding trajectories: the arrays ``mgn_tpu``'s
  ``write_ns_dataset`` writes to HDF5 for the same arguments, which the
  GPU machine reads without ``h5py``.

The numpy/scipy arithmetic is the JAX package's, line for line, so the same
arguments give the same bits.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
from scipy.fft import dctn, idctn
from scipy.spatial import Delaunay

from mgn_tpu_torch.data.tfrecord_writer import example_bytes, write_tfrecord

__all__ = ["solve_ns_channel", "make_cylinder_mesh", "write_ns_tfrecord_dataset",
           "interp_grid_to_mesh"]

# Domain: [0, LX] x [0, LY]; cylinder of diameter D at (CX, CY).
LX, LY = 2.0, 1.0
CX, CY, D = 0.45, 0.52, 0.16   # slightly off-center: seeds wake asymmetry
NU_DEFAULT = 1.1e-3            # nu = U*D/Re -> Re ~ 145 at U_peak = 1.0


def _poisson_neumann(rhs: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Solve lap(p) = rhs with homogeneous Neumann BCs on a cell-centered
    grid, exactly, via DCT-II diagonalization.  Mean of p is pinned to 0
    (all-Neumann Poisson is defined up to a constant)."""
    nx, ny = rhs.shape
    r = dctn(rhs, type=2, norm="ortho")
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    lam = (2.0 * (np.cos(np.pi * i / nx) - 1.0) / dx ** 2
           + 2.0 * (np.cos(np.pi * j / ny) - 1.0) / dy ** 2)
    lam[0, 0] = 1.0          # zero mode: pin the constant
    r = r / lam
    r[0, 0] = 0.0
    return idctn(r, type=2, norm="ortho")


def _upwind_grad(f: np.ndarray, u: np.ndarray, v: np.ndarray,
                 dx: float, dy: float) -> np.ndarray:
    """u . grad(f) with first-order upwind biasing (stable at coarse dx)."""
    fxm = (f - np.roll(f, 1, 0)) / dx      # backward
    fxp = (np.roll(f, -1, 0) - f) / dx     # forward
    fym = (f - np.roll(f, 1, 1)) / dy
    fyp = (np.roll(f, -1, 1) - f) / dy
    return (np.where(u > 0, u * fxm, u * fxp)
            + np.where(v > 0, v * fym, v * fyp))


def _laplacian(f: np.ndarray, dx: float, dy: float) -> np.ndarray:
    return ((np.roll(f, -1, 0) - 2 * f + np.roll(f, 1, 0)) / dx ** 2
            + (np.roll(f, -1, 1) - 2 * f + np.roll(f, 1, 1)) / dy ** 2)


def solve_ns_channel(
    nx: int = 256, ny: int = 128, u_peak: float = 1.0, nu: float = NU_DEFAULT,
    dt: float = 2e-3, frames: int = 600, frame_dt: float = 0.01,
    spin_up: float = 18.0, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Integrate channel flow past the cylinder; sample ``frames`` snapshots
    every ``frame_dt`` after a ``spin_up`` transient (plus a random extra
    fraction of a shedding period so trajectories differ in phase).

    Returns (U, V, (xs, ys)): U/V are (frames, nx, ny) float32 snapshot
    stacks at cell centers xs (nx,), ys (ny,).
    """
    rng = np.random.default_rng(seed)
    dx, dy = LX / nx, LY / ny
    xs = (np.arange(nx) + 0.5) * dx
    ys = (np.arange(ny) + 0.5) * dy
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    mask = (X - CX) ** 2 + (Y - CY) ** 2 <= (D / 2) ** 2   # solid cells

    prof = 4.0 * u_peak * ys * (1.0 - ys)                  # parabolic inflow
    u = np.broadcast_to(prof[None, :], (nx, ny)).copy()
    v = np.zeros((nx, ny))
    # transverse seed perturbation just behind the cylinder: breaks the
    # symmetric (steady) wake so shedding onsets within ~10 time units
    v += 0.3 * u_peak * np.exp(-(((X - CX - D) / (0.5 * D)) ** 2
                                 + ((Y - CY) / (0.5 * D)) ** 2))
    u[mask] = 0.0
    v[mask] = 0.0

    def apply_bc(u, v):
        u[0, :] = prof
        v[0, :] = 0.0
        u[-1, :] = u[-2, :]     # advective outflow (zero-gradient)
        v[-1, :] = v[-2, :]
        u[:, 0] = 0.0           # no-slip walls
        u[:, -1] = 0.0
        v[:, 0] = 0.0
        v[:, -1] = 0.0
        u[mask] = 0.0           # immersed cylinder, direct forcing
        v[mask] = 0.0

    def step(u, v):
        du = -_upwind_grad(u, u, v, dx, dy) + nu * _laplacian(u, dx, dy)
        dv = -_upwind_grad(v, u, v, dx, dy) + nu * _laplacian(v, dx, dy)
        u = u + dt * du
        v = v + dt * dv
        apply_bc(u, v)
        div = ((np.roll(u, -1, 0) - np.roll(u, 1, 0)) / (2 * dx)
               + (np.roll(v, -1, 1) - np.roll(v, 1, 1)) / (2 * dy))
        p = _poisson_neumann(div / dt, dx, dy)
        u = u - dt * (np.roll(p, -1, 0) - np.roll(p, 1, 0)) / (2 * dx)
        v = v - dt * (np.roll(p, -1, 1) - np.roll(p, 1, 1)) / (2 * dy)
        apply_bc(u, v)
        return u, v

    # shedding period ~ D / (St * U); randomize the sampled phase
    extra = float(rng.random()) * D / (0.2 * u_peak)
    n_spin = int(round((spin_up + extra) / dt))
    for _ in range(n_spin):
        u, v = step(u, v)

    sub = max(1, int(round(frame_dt / dt)))
    U = np.empty((frames, nx, ny), np.float32)
    V = np.empty((frames, nx, ny), np.float32)
    for f in range(frames):
        U[f], V[f] = u, v
        if f < frames - 1:
            for _ in range(sub):
                u, v = step(u, v)
    return U, V, (xs, ys)


def make_cylinder_mesh(num_nodes: int, seed: int = 0, n_ring: int = 48):
    """Triangulated channel mesh with a cylinder hole.

    Node types (the DeepMind convention):
    1 = inflow (x=0), 5 = outflow (x=LX), 6 = wall (y boundaries AND the
    cylinder surface ring), 0 = interior fluid.  Interior points are
    density-graded toward the cylinder (the wake region matters most).
    Triangles whose centroid falls inside the hole are dropped.
    """
    rng = np.random.default_rng(seed)
    n_side = max(4, int(np.sqrt(num_nodes / 2)))
    xs = np.linspace(0, LX, 2 * n_side)
    ys = np.linspace(0, LY, n_side)
    bound = np.concatenate([
        np.stack([xs, np.zeros_like(xs)], 1),
        np.stack([xs, np.full_like(xs, LY)], 1),
        np.stack([np.zeros(n_side - 2), ys[1:-1]], 1),
        np.stack([np.full(n_side - 2, LX), ys[1:-1]], 1),
    ])
    theta = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    ring = np.stack([CX + (D / 2) * np.cos(theta),
                     CY + (D / 2) * np.sin(theta)], 1)
    n_int = max(0, num_nodes - len(bound) - n_ring)
    # rejection-sample interior points: graded density (probability of
    # keeping a uniform draw rises near the cylinder/wake), hole excluded
    pts = []
    want = n_int
    while want > 0:
        cand = rng.random((want * 3, 2)) * [LX - 0.04, LY - 0.04] + 0.02
        r = np.hypot(cand[:, 0] - CX, cand[:, 1] - CY)
        keep_p = np.where(cand[:, 0] > CX - 2 * D,
                          np.clip(1.6 - 0.8 * r / D, 0.35, 1.0), 0.35)
        sel = (rng.random(len(cand)) < keep_p) & (r > D / 2 + 0.01)
        cand = cand[sel][:want]
        pts.append(cand)
        want -= len(cand)
    interior = np.concatenate(pts, 0) if pts else np.zeros((0, 2))
    pos = np.concatenate([bound, ring, interior], 0).astype(np.float32)
    tri = Delaunay(pos)
    cells = tri.simplices.astype(np.int32)
    cent = pos[cells].mean(1)
    keep = np.hypot(cent[:, 0] - CX, cent[:, 1] - CY) > D / 2 * 0.98
    cells = cells[keep]
    node_type = np.zeros(len(pos), np.int32)
    node_type[np.abs(pos[:, 1]) < 1e-6] = 6
    node_type[np.abs(pos[:, 1] - LY) < 1e-6] = 6
    node_type[np.abs(pos[:, 0] - LX) < 1e-6] = 5
    node_type[np.abs(pos[:, 0]) < 1e-6] = 1
    ring_lo = len(bound)
    node_type[ring_lo:ring_lo + n_ring] = 6   # cylinder surface = wall
    return pos, cells, node_type


def interp_grid_to_mesh(U: np.ndarray, V: np.ndarray, xs: np.ndarray,
                        ys: np.ndarray, mesh_pos: np.ndarray) -> np.ndarray:
    """Bilinear interpolation of (T, nx, ny) grid stacks onto mesh nodes;
    returns (T, N, 2) float32.  Weights computed once, applied to all T."""
    dx, dy = xs[1] - xs[0], ys[1] - ys[0]
    fx = np.clip((mesh_pos[:, 0] - xs[0]) / dx, 0, len(xs) - 1 - 1e-6)
    fy = np.clip((mesh_pos[:, 1] - ys[0]) / dy, 0, len(ys) - 1 - 1e-6)
    i0 = fx.astype(np.int64)
    j0 = fy.astype(np.int64)
    wx = (fx - i0)[None, :]
    wy = (fy - j0)[None, :]

    def bil(F):
        return ((1 - wx) * (1 - wy) * F[:, i0, j0]
                + wx * (1 - wy) * F[:, i0 + 1, j0]
                + (1 - wx) * wy * F[:, i0, j0 + 1]
                + wx * wy * F[:, i0 + 1, j0 + 1])

    return np.stack([bil(U), bil(V)], -1).astype(np.float32)


def _ns_meta(tl: int, n_train: int, n_valid: int, dt: float) -> Dict:
    return {
        "dt": dt,
        "trajectory_length": tl,
        "n_trajectories": n_train,
        "n_trajectories_valid": n_valid,
        "dims": 2,
        "physics": "incompressible NS vortex shedding (projection solver)",
        "feature_names": ["cells", "mesh_pos", "node_type", "velocity"],
        "target_features": ["velocity"],
        "features": {
            "cells": {"type": "static", "dim": 3, "shape": [1, -1, 3],
                      "dtype": "int32"},
            "mesh_pos": {"type": "static", "dim": 2, "shape": [1, -1, 2],
                         "dtype": "float32"},
            "node_type": {"type": "static", "dim": 1, "shape": [1, -1, 1],
                          "dtype": "int32", "onehot": True,
                          "data_min": 0, "data_max": 6},
            "velocity": {"type": "dynamic", "dim": 2, "shape": [tl, -1, 2],
                         "dtype": "float32"},
        },
    }


def write_ns_tfrecord_dataset(
    path: str, num_nodes: int = 1900, tl: int = 600, n_train: int = 32,
    n_valid: int = 2, n_test: int = 4, dt: float = 0.01, seed: int = 0,
    nx: int = 256, ny: int = 128, spin_up: float = 18.0,
    u_range: Tuple[float, float] = (0.85, 1.25), verbose: bool = True,
) -> Dict:
    """Write meta.json and train/valid/test TFRecord files of
    vortex-shedding trajectories.  One shared mesh; per-trajectory inflow
    peak speed drawn from ``u_range`` (Re ~ 125-180) and a random shedding
    phase (trajectory ``k``'s solver seed ``seed + 7000 + k``).  Idempotent:
    each split is written to a temporary file and renamed, meta.json is
    written last, and where it exists the call returns its contents at
    once (resumable runs)."""
    if os.path.exists(os.path.join(path, "meta.json")):
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)
    os.makedirs(path, exist_ok=True)
    pos, cells, node_type = make_cylinder_mesh(num_nodes, seed)
    meta = _ns_meta(tl, n_train, n_valid, dt)
    rng = np.random.default_rng(seed)
    k = 0
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        examples = []
        for i in range(n):
            u_peak = float(u_range[0] + (u_range[1] - u_range[0]) * rng.random())
            U, V, (gxs, gys) = solve_ns_channel(
                nx=nx, ny=ny, u_peak=u_peak, frames=tl, frame_dt=dt,
                spin_up=spin_up, seed=seed + 7000 + k)
            vel = interp_grid_to_mesh(U, V, gxs, gys, pos)
            vel[:, node_type == 6] = 0.0
            examples.append(example_bytes({
                "cells": cells[None], "mesh_pos": pos[None],
                "node_type": node_type[None, :, None], "velocity": vel}))
            if verbose:
                print(f"ns {split}[{i}] u_peak={u_peak:.3f} "
                      f"|v|max={np.abs(vel[..., 1]).max():.3f}", flush=True)
            k += 1
        tmp = os.path.join(path, f"{split}.tfrecord.tmp")
        write_tfrecord(tmp, examples)
        os.replace(tmp, os.path.join(path, f"{split}.tfrecord"))
    # meta last: its presence marks the dataset complete (idempotency token)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta
