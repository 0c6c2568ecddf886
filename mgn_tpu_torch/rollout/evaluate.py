"""Rollouts and their evaluation: the port's ``make_rollout_fn``,
``validation_loss``, ``rollout_error_report`` and ``export_rollouts_h5`` of
``mgn_tpu/rollout/evaluate.py``, and :func:`export_rollouts`, which writes
the same export as ``.npz`` where ``h5py`` is not installed."""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mgn_tpu_torch._device import tracing
from mgn_tpu_torch.data.hdf5 import import_h5py
from mgn_tpu_torch.models.mgn import MGNConfig
from mgn_tpu_torch.rollout.dynamics import Forward, make_deriv_fn, model_forward
from mgn_tpu_torch.rollout.integrators import (FIXED_METHODS, odeint_fixed,
                                               odeint_tsit5_adaptive, odeint_tsit5_loop)
from mgn_tpu_torch.train.common import FieldSpec, NormState, type_mask

__all__ = ["make_rollout_fn", "validation_loss", "timed_rollout", "rollout_error_report",
           "eval_record", "save_grid", "enclosing_frames", "export_rollouts",
           "export_rollouts_h5", "export_rollouts_npz"]


def make_rollout_fn(
    model_cfg: MGNConfig,
    spec: FieldSpec,
    solver: str = "euler",
    solver_dt: Optional[float] = None,
    solver_substeps: Optional[int] = None,
    types_updated: Tuple[int, ...] = (0, 5),
    types_inflow: Tuple[int, ...] = (1,),
    rtol: float = 1e-4,
    atol: float = 1e-6,
    forced: bool = True,
    forward: Forward = model_forward,
    group=None,
    stats: Optional[list] = None,
) -> Callable:
    """Build ``rollout(params, norm, template, fields, times, forcing_times)
    -> pred`` of shape ``(T, N_pad, output_dim)``, ``pred[0]`` the initial
    state.  ``solver`` is a fixed-step method name or ``"tsit5_adaptive"``
    (:func:`odeint_tsit5_adaptive` with ``rtol``/``atol``; one host sync per
    try; ``stats`` receives its ``(accepted, rejected)`` tries per save
    interval).  Under a trace (``torch.export``) the adaptive solver is
    :func:`odeint_tsit5_loop`, its controller on the device, and ``stats``
    receives its ``(T_save - 1, 2)`` tensor of tries.

    ``forced=False`` disables the inflow ground-truth forcing — a pure
    autoregressive simulation from the initial frame (serving); ``fields``
    may then hold a single frame.  ``forward`` and ``group`` make it a
    graph-parallel part's rollout (:func:`mgn_tpu_torch.parallel.rollout.
    make_sharded_rollout_fn`): the part's forward with its exchange over
    ``template`` (the rank's ``ShardGraph``), the adaptive solver's error
    norm summed over the graph group ``group``.
    """
    if solver != "tsit5_adaptive" and solver not in FIXED_METHODS:
        raise ValueError(f"unknown solver {solver!r}; choose one of "
                         f"{sorted(FIXED_METHODS) + ['tsit5_adaptive']}")

    def rollout(params, norm: NormState, template, fields: Dict[str, torch.Tensor],
                times: torch.Tensor,
                forcing_times: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``times`` is the save grid; ``forcing_times`` are the timestamps of
        ``fields``' frames (defaults to ``times``).  The initial state is the
        data frame enclosing ``times[0]``."""
        node_mask = template.node_mask
        val_mask = (type_mask(template.node_type, types_updated) & node_mask).float()
        inflow_mask = type_mask(template.node_type, types_inflow) & node_mask
        gt = torch.cat([fields[f] for f in spec.target_fields], dim=-1)
        ftimes = times if forcing_times is None else forcing_times
        eps = (1e-4 * torch.diff(ftimes).min() if ftimes.shape[0] > 1
               else torch.zeros((), dtype=torch.float32, device=ftimes.device))
        # (1,): the frame's rows by index_select, which stops no trace (torch.export)
        i0 = torch.clamp(torch.searchsorted(ftimes, (times[0] + eps).reshape(1),
                                            right=True) - 1, 0, ftimes.shape[0] - 1)
        y0 = gt.index_select(0, i0)[0]
        non_target = {f: fields[f].index_select(0, i0)[0] for f in spec.fields
                      if f not in spec.target_fields}
        deriv = make_deriv_fn(
            params, model_cfg, norm, template, spec, non_target, val_mask,
            inflow_mask=inflow_mask,
            forcing_data=gt if forced else None,
            forcing_times=ftimes,
            forward=forward,
        )
        if solver == "tsit5_adaptive" and tracing():
            ys, tries = odeint_tsit5_loop(deriv, y0, times, rtol=rtol, atol=atol, group=group)
            if stats is not None:
                stats.append(tries)
            return ys
        if solver == "tsit5_adaptive":
            return odeint_tsit5_adaptive(deriv, y0, times, rtol=rtol, atol=atol, group=group,
                                         stats=stats)
        return odeint_fixed(deriv, y0, times, dt=solver_dt, method=solver,
                            substeps=solver_substeps)

    return rollout


def validation_loss(pred: torch.Tensor, gt: torch.Tensor, update_mask: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Masked rollout MSE over (time, nodes, channels); with ``group`` (a
    :class:`~mgn_tpu_torch.parallel.mesh.Comm`) over the whole mesh, its
    parts' error and count summed over the group in one ``all_reduce``."""
    err = (pred - gt) ** 2
    m = update_mask.to(pred.dtype)[None, :, None]
    num, denom = (err * m).sum(), m.sum() * pred.shape[0] * pred.shape[-1]
    if group is not None:
        num, denom = group.all_reduce(torch.stack([num, denom]))
    return num / torch.clamp(denom, min=1.0)


def timed_rollout(run: Callable[[], torch.Tensor], warm: bool = False
                  ) -> Tuple[torch.Tensor, float]:
    """``run()``'s rollout and its seconds on the host clock, taken to the
    end of the device's work (``torch.cuda.synchronize()`` where the result
    lies on a GPU).  ``warm``: run it once first, untimed (on the GPU: the
    kernels' builds and first launches; the CPU's plain path has neither)."""
    def finished() -> torch.Tensor:
        pred = run()
        if pred.is_cuda:
            torch.cuda.synchronize(pred.device)
        return pred

    if warm:
        finished()
    t0 = time.perf_counter()
    pred = finished()
    return pred, time.perf_counter() - t0


def rollout_error_report(pred: np.ndarray, gt: np.ndarray, num_nodes: int,
                         mse_steps: Sequence[int] = ()) -> Dict[str, Any]:
    """Per-horizon error report: per-node squared error (``error``), the
    mean squared error per step (``mse_t``), ``mse``, ``cum_mse`` and
    ``cum_rmse`` at each requested horizon index within the rollout, and the
    rollout's ``final_rmse``.  Numpy, on the first ``num_nodes`` nodes."""
    pred = np.asarray(pred)[:, :num_nodes]
    gt = np.asarray(gt)[:, :num_nodes]
    err = np.mean((pred - gt) ** 2, axis=(1, 2))  # (T,)
    report: Dict[str, Any] = {"error": (pred - gt) ** 2, "mse_t": err}
    horizons = {}
    for s in mse_steps:
        s = int(s)
        if s < len(err):
            horizons[s] = {
                "mse": float(err[s]),
                "cum_mse": float(err[: s + 1].mean()),
                "cum_rmse": float(np.sqrt(err[: s + 1].mean())),
            }
    report["horizons"] = horizons
    report["final_rmse"] = float(np.sqrt(err.mean()))
    return report


def save_grid(data_t: np.ndarray, start: Optional[float] = None, stop: Optional[float] = None,
              saves: Optional[np.ndarray] = None) -> np.ndarray:
    """An evaluation's save times: ``saves``, or the data's times ``data_t``
    cut to ``[start, stop]``."""
    if saves is not None:
        return np.asarray(saves, np.float32)
    times = data_t
    if start is not None:
        times = times[times >= start - 1e-9]
    if stop is not None:
        times = times[times <= stop + 1e-9]
    return times


def enclosing_frames(data_t: np.ndarray, times: np.ndarray) -> np.ndarray:
    """The index of the data frame enclosing each save time, so windowed and
    arbitrary-saveat rollouts compare aligned frames."""
    return np.clip(np.searchsorted(data_t, times + 1e-4 * np.diff(data_t).min(),
                                   side="right") - 1, 0, len(data_t) - 1)


def eval_record(i: int, traj, pred: np.ndarray, gt: np.ndarray, timesteps: np.ndarray,
                seconds: float, mse_steps: Sequence[int], log) -> Tuple[Dict[str, Any],
                                                                      Dict[str, np.ndarray]]:
    """Trajectory ``i``'s evaluation: its :func:`rollout_error_report` with
    ``rollout_seconds`` and ``steps_per_second``, logged as an ``eval``
    record, and its export record for :func:`export_rollouts`.  ``pred``
    and ``gt`` are ``(T, N, dim)`` in the dataset's node order."""
    report = rollout_error_report(pred, gt, traj.num_nodes, mse_steps)
    report["rollout_seconds"] = seconds
    report["steps_per_second"] = (pred.shape[0] - 1) / max(seconds, 1e-9)
    log.log("eval", trajectory=i, final_rmse=report["final_rmse"],
            steps_per_s=report["steps_per_second"],
            **{f"mse@{k}": v["mse"] for k, v in report["horizons"].items()})
    return report, {"mesh_pos": traj.mesh_pos, "cells": traj.cells, "gt": gt,
                    "prediction": pred, "error": report["error"], "timesteps": timesteps}


_EXPORT_KEYS = ("mesh_pos", "gt", "prediction", "error", "timesteps", "cells")


def _export_dir(out_path: str, solver_name: str) -> str:
    d = os.path.join(out_path, solver_name)
    os.makedirs(d, exist_ok=True)
    return d


def export_rollouts_h5(out_path: str, solver_name: str,
                       rollouts: Sequence[Dict[str, np.ndarray]]) -> str:
    """Write ``<out_path>/<solver_name>/trajectories.h5``: one group per
    rollout (``"0"``, ``"1"``, ...) holding ``mesh_pos``, ``gt``,
    ``prediction``, ``error``, ``timesteps`` and ``cells`` where given, as
    ``mgn_tpu`` writes it.  Needs ``h5py``."""
    h5py = import_h5py("writing trajectories.h5")
    path = os.path.join(_export_dir(out_path, solver_name), "trajectories.h5")
    with h5py.File(path, "w") as f:
        for i, r in enumerate(rollouts):
            g = f.create_group(str(i))
            for k in _EXPORT_KEYS:
                if k in r and r[k] is not None:
                    g[k] = np.asarray(r[k])
    return path


def export_rollouts_npz(out_path: str, solver_name: str,
                        rollouts: Sequence[Dict[str, np.ndarray]]) -> str:
    """Write ``<out_path>/<solver_name>/trajectories.npz``: the arrays of
    :func:`export_rollouts_h5`, rollout ``i``'s array ``name`` under the key
    ``"<i>/<name>"`` (``np.load(path)["0/prediction"]``).  Needs no ``h5py``."""
    path = os.path.join(_export_dir(out_path, solver_name), "trajectories.npz")
    np.savez(path, **{f"{i}/{k}": np.asarray(r[k]) for i, r in enumerate(rollouts)
                      for k in _EXPORT_KEYS if k in r and r[k] is not None})
    return path


def export_rollouts(out_path: str, solver_name: str,
                    rollouts: Sequence[Dict[str, np.ndarray]]) -> str:
    """The rollouts' export: ``trajectories.h5`` (:func:`export_rollouts_h5`)
    where ``h5py`` is installed, else the same arrays as ``trajectories.npz``
    (:func:`export_rollouts_npz`).  Returns the path written."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return export_rollouts_npz(out_path, solver_name, rollouts)
    return export_rollouts_h5(out_path, solver_name, rollouts)
