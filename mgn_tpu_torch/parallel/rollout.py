"""Graph-parallel rollouts: the port's ``mgn_tpu/parallel/rollout.py``.

Each rank rolls out its part of the mesh (its rows of the state slab,
``(N_p, F_out)``) through the single-device rollout
(:func:`mgn_tpu_torch.rollout.evaluate.make_rollout_fn`) with the part's
forward and its exchange as the right-hand side's network
(:func:`shard_forward`), so the ranks of one graph group call it in step:

- fixed-step solvers run per part unchanged;
- the adaptive Tsit5 sums its squared error over the group
  (``odeint_tsit5_adaptive(group=)``), so every rank accepts, rejects and
  sizes the same step;
- the masked validation loss reduces per part and sums over the group.

:func:`unpermute_sharded` gives every rank the whole prediction in the
dataset's node order; :func:`gather_parts` gathers the parts on the device
(what a sharded serving artefact runs, :mod:`mgn_tpu_torch.serve`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mgn_tpu_torch.models.mgn import MGNConfig
from mgn_tpu_torch.parallel.halo import ShardGraph
from mgn_tpu_torch.parallel.mesh import Comm
from mgn_tpu_torch.parallel.partition import PartitionedTemplate, global_ids
from mgn_tpu_torch.parallel.spmd import partition_stack, shard_forward
from mgn_tpu_torch.rollout.evaluate import make_rollout_fn, validation_loss
from mgn_tpu_torch.train.common import FieldSpec, NormState, type_mask

__all__ = ["partition_stack", "shard_forward", "make_part_rollout_fn",
           "make_sharded_rollout_fn", "unpermute_sharded", "gather_parts", "gather_prediction"]


def unpermute_sharded(pt: PartitionedTemplate, pred: np.ndarray, num_nodes: int) -> np.ndarray:
    """``(T, P, N_p, F)`` part-layout predictions -> ``(T, num_nodes, F)``
    in the dataset's node order."""
    pred = np.asarray(pred)
    flat = pred.reshape(pred.shape[0], pt.num_parts * pt.part_nodes, -1)
    return flat[:, global_ids(pt, num_nodes)]


def gather_parts(pred: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Every part's ``(T, N_p, F)`` prediction as ``(T, P, N_p, F)`` on the
    device, on every rank of the group (one ``all_gather``, which traces)."""
    full = comm.all_gather(pred.contiguous())
    return full.view((comm.size,) + tuple(pred.shape)).transpose(0, 1)


def gather_prediction(pred: torch.Tensor, comm: Comm) -> np.ndarray:
    """:func:`gather_parts` on the host."""
    return gather_parts(pred, comm).cpu().numpy()


def make_part_rollout_fn(comm: Comm, model_cfg: MGNConfig, spec: FieldSpec,
                         solver: str = "euler", solver_substeps: Optional[int] = None,
                         types_updated: Tuple[int, ...] = (0, 5),
                         types_inflow: Tuple[int, ...] = (1,), rtol: float = 1e-4,
                         atol: float = 1e-6, forced: bool = True,
                         stats: Optional[list] = None) -> Callable:
    """Build ``rollout(params, norm, shard, fields, times, forcing_times=None)
    -> pred`` over the graph group ``comm``: ``make_rollout_fn``'s rollout
    of this rank's part (arguments as for :func:`make_sharded_rollout_fn`),
    ``pred`` ``(T_save, N_p, F_out)``.  Under a trace (a sharded serving
    artefact) the adaptive solver is the device controller and ``stats``
    receives its tries as a tensor."""
    return make_rollout_fn(model_cfg, spec, solver, solver_substeps=solver_substeps,
                           types_updated=types_updated, types_inflow=types_inflow,
                           rtol=rtol, atol=atol, forced=forced,
                           forward=shard_forward(comm), group=comm, stats=stats)


def make_sharded_rollout_fn(comm: Comm, model_cfg: MGNConfig, spec: FieldSpec,
                            solver: str = "euler", solver_substeps: Optional[int] = None,
                            types_updated: Tuple[int, ...] = (0, 5),
                            types_inflow: Tuple[int, ...] = (1,), rtol: float = 1e-4,
                            atol: float = 1e-6, forced: bool = True,
                            stats: Optional[list] = None) -> Callable:
    """Build ``rollout(params, norm, shard, fields, times, forcing_times=None)
    -> (pred, loss)`` over the graph group ``comm``: ``make_rollout_fn``'s
    rollout of this rank's part.

    ``shard`` is this rank's :class:`~mgn_tpu_torch.parallel.halo.ShardGraph`,
    ``fields`` its rows of each field's stack ``(T, N_p, dim)``, ``times``
    the save grid, ``forcing_times`` the frames' timestamps (default
    ``times``).  ``pred`` ``(T_save, N_p, F_out)`` is this part's; ``loss``
    the masked rollout MSE against the data frame enclosing each save time,
    over the whole mesh (summed over the group), the same on every rank.
    ``stats``: a list that receives the adaptive solver's ``(accepted,
    rejected)`` tries per save interval."""
    rollout = make_part_rollout_fn(comm, model_cfg, spec, solver, solver_substeps,
                                   types_updated, types_inflow, rtol, atol, forced, stats)

    def sharded(params, norm: NormState, shard: ShardGraph, fields: Dict[str, torch.Tensor],
                times: torch.Tensor, forcing_times: Optional[torch.Tensor] = None):
        pred = rollout(params, norm, shard, fields, times, forcing_times)
        ftimes = times if forcing_times is None else forcing_times
        eps = (1e-4 * torch.diff(ftimes).min() if ftimes.shape[0] > 1
               else torch.zeros((), dtype=torch.float32, device=ftimes.device))
        fidx = torch.clamp(torch.searchsorted(ftimes, times + eps, right=True) - 1,
                           0, ftimes.shape[0] - 1)
        gt = torch.cat([fields[f] for f in spec.target_fields], dim=-1).index_select(0, fidx)
        mask = type_mask(shard.node_type, types_updated) & shard.node_mask
        return pred, validation_loss(pred, gt, mask, comm)

    return sharded
