"""Rollouts: the port's ``make_rollout_fn`` and ``validation_loss`` of
``mgn_tpu/rollout/evaluate.py``.  The error reports and the HDF5 export come
with the evaluation slice."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mgn_tpu_torch.models.mgn import MGNConfig
from mgn_tpu_torch.rollout.dynamics import make_deriv_fn
from mgn_tpu_torch.rollout.integrators import FIXED_METHODS, odeint_fixed, odeint_tsit5_adaptive
from mgn_tpu_torch.train.common import FieldSpec, NormState, type_mask

__all__ = ["make_rollout_fn", "validation_loss"]


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
) -> Callable:
    """Build ``rollout(params, norm, template, fields, times, forcing_times)
    -> pred`` of shape ``(T, N_pad, output_dim)``, ``pred[0]`` the initial
    state.  ``solver`` is a fixed-step method name or ``"tsit5_adaptive"``
    (:func:`odeint_tsit5_adaptive` with ``rtol``/``atol``; one host sync per
    try).

    ``forced=False`` disables the inflow ground-truth forcing — a pure
    autoregressive simulation from the initial frame (serving); ``fields``
    may then hold a single frame.
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
        i0 = torch.clamp(torch.searchsorted(ftimes, (times[0] + eps).reshape(1),
                                            right=True)[0] - 1, 0, ftimes.shape[0] - 1)
        y0 = gt[i0]
        non_target = {f: fields[f][i0] for f in spec.fields
                      if f not in spec.target_fields}
        deriv = make_deriv_fn(
            params, model_cfg, norm, template, spec, non_target, val_mask,
            inflow_mask=inflow_mask,
            forcing_data=gt if forced else None,
            forcing_times=ftimes,
        )
        if solver == "tsit5_adaptive":
            return odeint_tsit5_adaptive(deriv, y0, times, rtol=rtol, atol=atol)
        return odeint_fixed(deriv, y0, times, dt=solver_dt, method=solver,
                            substeps=solver_substeps)

    return rollout


def validation_loss(pred: torch.Tensor, gt: torch.Tensor,
                    update_mask: torch.Tensor) -> torch.Tensor:
    """Masked rollout MSE over (time, nodes, channels)."""
    err = (pred - gt) ** 2
    m = update_mask.to(pred.dtype)[None, :, None]
    denom = m.sum() * pred.shape[0] * pred.shape[-1]
    return (err * m).sum() / torch.clamp(denom, min=1.0)
