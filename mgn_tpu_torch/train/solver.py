"""Solver-based (NeuralODE) training: the port's ``mgn_tpu/train/solver.py``,
``SolverTraining`` and ``MultipleShooting``.

The loss is taken on an ODE solve of the learned dynamics and differentiated
through the solver: the discrete adjoint, autograd through the integrator's
steps (:func:`~mgn_tpu_torch.rollout.integrators.odeint_fixed`, or
:func:`~mgn_tpu_torch.rollout.integrators.odeint_tsit5_bounded` for
``solver="tsit5_adaptive"``), each forward and backward of the processor
through the kernels of :mod:`mgn_tpu_torch.ops.fused`.  Semantics kept from
the JAX package:

- the save grid ``tstart + arange(n) * dt`` (f32), each save time mapped to
  the data frame at or below it (``searchsorted`` with ``eps = 1e-4 *
  min(diff(times))``), so per-trajectory non-uniform ``dt`` works;
- the normalizers accumulate once a step, before the loss, over the
  ground-truth save frames (node fields) and their finite differences over
  the first data interval (outputs);
- inflow nodes forced from ground truth during the solve
  (:func:`~mgn_tpu_torch.rollout.dynamics.make_deriv_fn`);
- the loss on normalized predictions against normalized ground truth,
  masked to the updated node types, averaged over nodes, channels and save
  points;
- MultipleShooting: windows of ``interval_size`` save points started from
  ground truth at ``min(arange(0, n_save - 1, stride), n_save -
  interval_size)`` (``stride = interval_size - 1``; a ragged last window
  slides back), their times ``saveat[0] + (start + arange(interval_size))
  * dt``, and an L1 continuity gap of each window's end against ground
  truth, the last window's left out of the sum;
- no noise; the update is skipped while ``step < norm_steps`` and where the
  loss or any gradient is not finite, the step counter advancing either
  way.

Differences of form: the JAX package maps the windows with ``lax.map``;
here they are a Python loop that runs one backward a window (the loss is a
sum over windows, so the gradients add up to the whole loss's), which holds
one window's activations at a time.  A skipped update takes no
``optimizer.step()``, so Adam's moments and its count stay, as JAX's
``jnp.where`` keeps them; during the warm-up the solve runs under
``torch.no_grad()``.  The finiteness check is one host sync a step.

Memory plan.  A differentiated forward saves the processor's per-round
stacks (``v``, ``e`` and the aggregate: about 116 MB at the cylinder in f32,
latent 128, 15 rounds) and the weight streams.  Without ``remat`` a step
holds every forward's: Euler over ``T`` save intervals ``T`` of them
(about 1.2 GB at ``T = 10``), RK4 four a substep, the bounded Tsit5 seven a
try (up to ``7 * substeps_max`` an interval).  With ``remat`` (the default,
as in the JAX package) autograd keeps only each substep's input state; the
backward runs one substep's forward again at a time, so one substep's
stacks are live at once beside the ``T`` states (plus, for the bounded
Tsit5, the host decisions).  The cost is one more forward a stage in the
backward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple, Union

import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import GraphTemplate
from mgn_tpu_torch.models.mgn import MGNConfig
from mgn_tpu_torch.rollout.dynamics import make_deriv_fn
from mgn_tpu_torch.rollout.integrators import odeint_fixed, odeint_tsit5_bounded
from mgn_tpu_torch.train.common import (FieldSpec, NormState, TrainState, param_leaves,
                                        type_mask)
from mgn_tpu_torch.train.strategies import MultipleShooting, SolverTraining

__all__ = ["SolverTrainerConfig", "make_solver_trainer", "integrator", "solve_fn"]


@dataclasses.dataclass(frozen=True)
class SolverTrainerConfig:
    model: MGNConfig
    spec: FieldSpec
    strategy: Union[SolverTraining, MultipleShooting]
    types_updated: Tuple[int, ...] = (0, 5)
    types_inflow: Tuple[int, ...] = (1,)
    norm_steps: int = 1000


def _save_grid(strategy: Union[SolverTraining, MultipleShooting],
               device: torch.device) -> torch.Tensor:
    """The strategy's save times ``tstart + arange(n) * dt`` in f32."""
    n = int(round((strategy.tstop - strategy.tstart) / strategy.dt)) + 1
    return strategy.tstart + torch.arange(n, dtype=torch.float32, device=device) * strategy.dt


def _accumulate(norm: NormState, spec: FieldSpec, gt_fields: Dict[str, torch.Tensor],
                node_mask: torch.Tensor, mesh_edges: torch.Tensor, edge_mask: torch.Tensor,
                dt0: torch.Tensor, comm=None) -> NormState:
    """One accumulation over the save frames (node fields), their finite
    differences over ``dt0`` (outputs) and the mesh edges; with ``comm`` (a
    :class:`~mgn_tpu_torch.parallel.mesh.Comm`) each new batch's sums are
    summed over its ranks in one ``all_reduce``."""
    diffs = {f: (gt_fields[f][1:] - gt_fields[f][:-1]) / dt0 for f in spec.target_fields}

    def rows(norms, fields):
        return [(norms[f], x.reshape(-1, x.shape[-1]), node_mask.repeat(x.shape[0]))
                for f, x in fields.items()]

    acc = N.accumulate_synced_all(rows(norm.node, gt_fields) + rows(norm.output, diffs)
                                  + [(norm.edge, mesh_edges, edge_mask)], comm)
    n = len(gt_fields)
    return NormState(edge=acc[-1], node={**norm.node, **dict(zip(gt_fields, acc))},
                     output={**norm.output, **dict(zip(diffs, acc[n:-1]))})


def _normalized(norm: NormState, spec: FieldSpec, slab: torch.Tensor) -> torch.Tensor:
    """``(..., N, F)`` target slab -> node-normalized per target field."""
    return torch.cat([norm.node[f](slab[..., sl])
                      for f, sl in zip(spec.target_fields, spec.target_slices())], dim=-1)


def make_solver_trainer(cfg: SolverTrainerConfig) -> Callable:
    """Build ``train_step(state, template, fields, times) -> (state,
    losses)``: one optimizer step on one trajectory (or one disjoint-union
    graph of B of them, which share ``times``).

    - ``fields``: dict of dynamic node fields, each ``(T, N_pad, dim)`` on
      the training device; ``times``: ``(T,)`` f32 data timestamps;
    - returns ``(state, losses (1,) f32 on the host)``, as the derivative
      trainers do; ``state`` is updated in place (parameters through its
      optimizer, the normalizers, the step) and returned.
    """
    spec, strategy = cfg.spec, cfg.strategy
    integrate = integrator(strategy)

    def train_step(state: TrainState, template: GraphTemplate,
                   fields: Dict[str, torch.Tensor],
                   times: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        saveat = _save_grid(strategy, times.device)
        node_mask = template.node_mask
        val_mask = (type_mask(template.node_type, cfg.types_updated) & node_mask).float()
        inflow_mask = type_mask(template.node_type, cfg.types_inflow) & node_mask
        with torch.no_grad():
            gt_fields = {f: fields[f][_save_frames(times, saveat)] for f in spec.fields}
            state.norm = norm = _accumulate(state.norm, spec, gt_fields, template.node_mask,
                                            template.mesh_edge_features, template.edge_mask,
                                            times[1] - times[0])
            gt = torch.cat([gt_fields[f] for f in spec.target_fields], dim=-1)
            non_target = {f: gt_fields[f][0] for f in spec.fields
                          if f not in spec.target_fields}
        denom = torch.clamp(val_mask.sum() * gt.shape[-1], min=1.0)
        deriv = make_deriv_fn(state.params, cfg.model, norm, template, spec, non_target,
                              val_mask, inflow_mask=inflow_mask, forcing_data=gt,
                              forcing_times=saveat)
        solve = solve_fn(strategy, integrate, deriv, norm, spec, gt, val_mask, denom, saveat)
        loss = _guarded_step(state, cfg.norm_steps, solve)
        return state, loss.reshape(1).float().cpu()

    return train_step


def integrator(strategy: Union[SolverTraining, MultipleShooting], group=None) -> Callable:
    """The strategy's ``integrate(deriv, y0, grid)``: the bounded adaptive
    Tsit5 for ``solver="tsit5_adaptive"`` (its error norm summed over
    ``group``, a :class:`~mgn_tpu_torch.parallel.mesh.Comm`, where the state
    is sharded), else the fixed-step method with ``dt / solver_dt``
    substeps a save interval."""
    substeps = (1 if strategy.solver_dt is None
                else max(1, int(round(strategy.dt / strategy.solver_dt))))

    def integrate(deriv, y0, grid):
        if strategy.solver == "tsit5_adaptive":
            return odeint_tsit5_bounded(deriv, y0, grid, rtol=strategy.rtol, atol=strategy.atol,
                                        substeps_max=strategy.adaptive_substeps,
                                        remat=strategy.remat, group=group)
        return odeint_fixed(deriv, y0, grid, substeps=substeps, method=strategy.solver,
                            remat=strategy.remat)

    return integrate


def _save_frames(times: torch.Tensor, saveat: torch.Tensor) -> torch.Tensor:
    """The data frame at or below each save time (``eps = 1e-4 *
    min(diff(times))``, so a save time on a frame's timestamp takes it)."""
    eps = 1e-4 * torch.diff(times).min()
    return torch.clamp(torch.searchsorted(times, saveat + eps, right=True) - 1,
                       0, times.shape[0] - 1)


def solve_fn(strategy: Union[SolverTraining, MultipleShooting], integrate: Callable,
             deriv: Callable, norm: NormState, spec: FieldSpec, gt: torch.Tensor,
             val_mask: torch.Tensor, denom: torch.Tensor, saveat: torch.Tensor,
             scale: float = 1.0) -> Callable[[bool], torch.Tensor]:
    """The step's ``solve(backward) -> loss`` over the ground truth ``gt``
    ``(n_save, N, F)``: the solve of ``deriv`` by ``integrate(deriv, y0,
    grid)``, the masked MSE of its normalized predictions over ``denom``
    (updated nodes times channels) and the save points, for MultipleShooting
    per window with the continuity gaps; the loss times ``scale``.  With
    ``backward``, its gradient is accumulated into the parameters' ``.grad``
    (one backward a shooting window, the windows in order)."""
    n_save = saveat.shape[0]
    with torch.no_grad():
        gt_n = _normalized(norm, spec, gt)
    vm3 = val_mask[None, :, None]

    def mse(pred, ref_n, n):
        return ((_normalized(norm, spec, pred) - ref_n) ** 2 * vm3).sum() / (denom * n)

    def scaled(x: torch.Tensor) -> torch.Tensor:
        return x if scale == 1.0 else x * scale

    def solve(backward: bool) -> torch.Tensor:
        if not isinstance(strategy, MultipleShooting):
            loss = scaled(mse(integrate(deriv, gt[0], saveat), gt_n, n_save))
            if backward:
                loss.backward()
            return loss.detach()
        k = strategy.interval_size
        starts = [min(s, n_save - k) for s in range(0, n_save - 1, k - 1)]
        offsets = torch.arange(k, device=saveat.device)
        mses, gaps = [], []
        for w, s in enumerate(starts):
            wt = saveat[0] + (s + offsets).float() * strategy.dt
            pred = integrate(deriv, gt[s], wt)
            m = scaled(mse(pred, gt_n[s:s + k], k))
            # continuity against the next window's ground-truth start
            gap = scaled(((pred[-1] - gt[s + k - 1]).abs() * val_mask[:, None]).sum())
            if backward:
                (m if w == len(starts) - 1 else m + strategy.continuity_term * gap).backward()
            mses.append(m.detach())
            gaps.append(gap.detach())
        return (torch.stack(mses).sum()
                + strategy.continuity_term * torch.stack(gaps)[:-1].sum())

    return solve


def _guarded_step(state: TrainState, norm_steps: int,
                  solve: Callable[[bool], torch.Tensor]) -> torch.Tensor:
    """Past the warm-up, ``solve(True)`` (loss and gradient) and one
    optimizer step where the loss and every gradient are finite; during it
    ``solve(False)`` under ``torch.no_grad()``.  Advances the step."""
    if state.step >= norm_steps:
        state.optimizer.zero_grad(set_to_none=True)
        loss = solve(True)
        checks: List[torch.Tensor] = [torch.isfinite(loss)]
        checks += [torch.isfinite(p.grad).all() for p in param_leaves(state.params)
                   if p.grad is not None]
        if bool(torch.stack(checks).all()):  # the step's one host sync
            state.optimizer.step()
    else:
        with torch.no_grad():
            loss = solve(False)
    state.step += 1
    return loss
