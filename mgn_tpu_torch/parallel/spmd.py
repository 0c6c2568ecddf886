"""Graph-parallel x data-parallel training: the port's ``SpmdBatch``,
``batch_from_partitioned``, ``make_spmd_derivative_step`` and
``make_spmd_solver_step`` of ``mgn_tpu/parallel/spmd.py``.

Rank ``(d, g)`` of the (data, graph) mesh (:mod:`mgn_tpu_torch.parallel.mesh`)
holds trajectory ``d``'s part ``g``.  A step, per rank: its frame's inputs
and raw targets, noise drawn from a ``torch.Generator`` seeded per data
coordinate (the counterpart of ``fold_in(key, axis_index("data"))``; its
numbers differ from ``jax.random``'s); the online normalizers accumulated
with the new batch's masked sums summed over the world in one
``all_reduce`` (:func:`mgn_tpu_torch.core.normalizers.accumulate_synced_all`);
the part's forward with its exchange (:func:`mgn_tpu_torch.parallel.halo.apply_shard`);
the masked loss over the global count of updated nodes (one ``all_reduce``);
its gradient, summed over the world in one flat ``all_reduce``; then the same
optimizer step on every rank, gated off during the first ``norm_steps``
steps as in the single-device trainer.

The solver step (:func:`make_spmd_solver_step`, ``SolverTraining`` and
``MultipleShooting``) solves the learned ODE over each rank's part with the
part's forward as the right-hand side's network (:func:`shard_forward`); its
loss terms stay shard-local and every reduction of the loss, the gradient
and the error norm's decisions runs outside autograd (the exchange
``Function``s' backwards already sum the cotangents across ranks).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.models.mgn import MGNConfig
from mgn_tpu_torch.parallel.halo import ShardGraph, apply_shard, shard_graph
from mgn_tpu_torch.parallel.mesh import Comm, DeviceMesh
from mgn_tpu_torch.parallel.partition import PartitionedTemplate, global_ids
from mgn_tpu_torch.rollout.dynamics import Forward, make_deriv_fn
from mgn_tpu_torch.train.common import (FieldSpec, NormState, TrainState, param_leaves,
                                        type_mask)
from mgn_tpu_torch.train.derivative import DerivativeTrainerConfig, frame_inputs
from mgn_tpu_torch.train.solver import (_accumulate, _guarded_step, _save_frames, _save_grid,
                                        integrator, solve_fn)
from mgn_tpu_torch.train.strategies import MultipleShooting, SolverTraining

__all__ = ["SpmdBatch", "RankShard", "batch_from_partitioned", "partition_stack",
           "make_spmd_derivative_step", "make_spmd_solver_step", "shard_features",
           "shard_forward"]


def partition_stack(pt: PartitionedTemplate, arr: np.ndarray) -> np.ndarray:
    """``(T, N, dim)`` original-order stack -> ``(P, T, N_p, dim)`` padded
    part layout."""
    t, n, d = arr.shape
    flat = np.zeros((t, pt.num_parts * pt.part_nodes, d), np.float32)
    flat[:, global_ids(pt, n)] = arr
    return np.ascontiguousarray(
        flat.reshape(t, pt.num_parts, pt.part_nodes, d).transpose(1, 0, 2, 3))


class RankShard(NamedTuple):
    """One rank's training data on its device: its part of its trajectory
    (:class:`~mgn_tpu_torch.parallel.halo.ShardGraph`), that part's rows of
    every field's time stack ``(T, N_p, dim)``, and the frame times."""

    graph: ShardGraph
    fields: Dict[str, torch.Tensor]
    times: torch.Tensor

    @property
    def nbytes(self) -> int:
        return (self.graph.nbytes + self.times.numel() * 4
                + sum(f.numel() * f.element_size() for f in self.fields.values()))


@dataclasses.dataclass
class SpmdBatch:
    """B partitioned trajectories on the host: the templates (with their
    exchange plans), every field's stack in the part layout ``(B, P, T, N_p,
    dim)`` (trajectories of unequal length edge-padded along T, which the
    frame sampler never draws) and the times ``(B, T)``."""

    templates: List[PartitionedTemplate]
    fields: Dict[str, np.ndarray]
    times: np.ndarray

    def shard(self, d: int, g: int, exchange: str, device) -> RankShard:
        """Rank ``(d, g)``'s :class:`RankShard` on ``device``."""
        return RankShard(shard_graph(self.templates[d], g, exchange, device),
                         {f: torch.as_tensor(a[d, g]).to(device) for f, a in self.fields.items()},
                         torch.as_tensor(self.times[d]).to(device))


def batch_from_partitioned(ptemplates: Sequence[PartitionedTemplate],
                           fields_list: Sequence[Dict[str, np.ndarray]],
                           times_list: Sequence[np.ndarray]) -> SpmdBatch:
    """Stack partitioned trajectories (host-side, once per trajectory
    group): ``fields_list`` holds each trajectory's ``{f: (T, N, dim)}`` in
    the dataset's node order."""
    t_max = max(fl[next(iter(fl))].shape[0] for fl in fields_list)

    def pad_t(arr):  # (T, ...) -> (t_max, ...) edge-replicated
        if arr.shape[0] == t_max:
            return arr
        return np.pad(arr, [(0, t_max - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1), mode="edge")

    fields = {f: np.stack([partition_stack(p, pad_t(np.asarray(fl[f], np.float32)))
                           for p, fl in zip(ptemplates, fields_list)])
              for f in fields_list[0]}
    times = np.stack([pad_t(np.asarray(t, np.float32)) for t in times_list])
    return SpmdBatch(list(ptemplates), fields, times)


def shard_features(norm: NormState, shard: ShardGraph, values: Dict[str, torch.Tensor],
                   spec: FieldSpec) -> torch.Tensor:
    """The part's normalized node features (``assemble_graph``'s, masked)."""
    parts = [norm.node[f](values[f]) for f in spec.fields]
    parts.append(norm.node["node_type"](shard.node_type_onehot))
    return torch.cat(parts, dim=-1) * shard.node_mask[:, None]


def shard_forward(comm: Comm) -> Forward:
    """The right-hand side's network on a graph-parallel part, for
    ``make_deriv_fn(forward=)``: the part's normalized node features
    (:func:`shard_features`) through
    :func:`~mgn_tpu_torch.parallel.halo.apply_shard`, exchanging over the
    graph group ``comm``."""
    def forward(params, model_cfg: MGNConfig, norm: NormState, shard: ShardGraph,
                spec: FieldSpec, values: Dict[str, torch.Tensor]) -> torch.Tensor:
        return apply_shard(params, shard_features(norm, shard, values, spec), norm.edge, shard,
                           model_cfg, comm)
    return forward


def _sum_grads(leaves: Sequence[torch.Tensor], comm: Comm) -> None:
    """Every leaf's gradient summed over ``comm``'s ranks in one flat ``all_reduce``."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    k = 0
    for p, g in zip(leaves, grads):
        p.grad = flat[k:k + g.numel()].view_as(g).clone()
        k += g.numel()


def make_spmd_derivative_step(mesh: DeviceMesh, model_cfg: MGNConfig, spec: FieldSpec,
                              noise_stddevs: Tuple[float, ...] = (0.0,),
                              types_updated: Tuple[int, ...] = (0, 5),
                              types_noisy: Tuple[int, ...] = (0,),
                              norm_steps: int = 0) -> Callable:
    """Build ``step(state, shard, perms, seed) -> (state, losses)``.

    ``shard`` is this rank's :class:`RankShard`; ``perms`` a ``(K, B)``
    array of host-sampled frame indices (the same on every rank): the step
    runs K optimizer updates on frames ``perms[:, d]`` of this rank's
    trajectory.  ``seed`` seeds the noise generator of this rank's data
    coordinate (``seed * B + d``).  ``state`` is updated in place and
    returned; ``losses`` ``(K,)`` f32 on the host, the global loss of each
    update, the same on every rank."""
    tcfg = DerivativeTrainerConfig(model=model_cfg, spec=spec, noise_stddevs=noise_stddevs,
                                   types_updated=types_updated, types_noisy=types_noisy,
                                   norm_steps=norm_steps)

    def one_update(state: TrainState, sh: RankShard, t: int, gen: torch.Generator):
        g = sh.graph
        node_mask = g.node_mask
        upd = (type_mask(g.node_type, types_updated) & node_mask).float()
        noisy = type_mask(g.node_type, types_noisy) & node_mask
        with torch.no_grad():
            u, targets_raw = frame_inputs(tcfg, sh.fields, sh.times, t, noisy, gen)
            norm = state.norm
            items = ([(norm.node[f], u[f], node_mask) for f in spec.fields]
                     + [(norm.output[f], targets_raw[f], node_mask) for f in spec.target_fields]
                     + [(norm.edge, g.mef, g.edge_mask)])
            acc = N.accumulate_synced_all(items, mesh.world)
            nf_ = len(spec.fields)
            norm = NormState(edge=acc[-1], node={**norm.node, **dict(zip(spec.fields, acc))},
                             output={**norm.output,
                                     **dict(zip(spec.target_fields, acc[nf_:-1]))})
            state.norm = norm
            target = torch.cat([norm.output[f](targets_raw[f]) for f in spec.target_fields], -1)
            nf = shard_features(norm, g, u, spec)
            count = mesh.world.all_reduce(upd.sum().reshape(1))

        def loss_fn():
            out = apply_shard(state.params, nf, norm.edge, g, model_cfg, mesh.graph_comm)
            sq = (((out - target) ** 2).sum(-1) * upd).sum()
            return sq / torch.clamp(count[0], min=1.0)

        if state.step >= norm_steps:
            state.optimizer.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            _sum_grads(param_leaves(state.params), mesh.world)
            state.optimizer.step()
        else:
            with torch.no_grad():
                loss = loss_fn()
        state.step += 1
        return mesh.world.all_reduce(loss.detach().reshape(1))[0]

    def step(state: TrainState, shard: RankShard, perms, seed: int):
        gen = torch.Generator(device=shard.times.device).manual_seed(
            int(seed) * mesh.data + mesh.data_rank)
        cols = np.asarray(perms).reshape(len(perms), -1)[:, mesh.data_rank]
        losses = [one_update(state, shard, int(t), gen) for t in cols]
        return state, torch.stack(losses).float().cpu()

    return step


def make_spmd_solver_step(mesh: DeviceMesh, model_cfg: MGNConfig, spec: FieldSpec,
                          strategy: Union[SolverTraining, MultipleShooting],
                          types_updated: Tuple[int, ...] = (0, 5),
                          types_inflow: Tuple[int, ...] = (1,),
                          norm_steps: int = 0) -> Callable:
    """Build ``step(state, shard) -> (state, losses)``: one optimizer step
    of ``SolverTraining`` or ``MultipleShooting`` on this rank's part of its
    trajectory (``shard``, a :class:`RankShard`), the single-device
    trainer's (:func:`mgn_tpu_torch.train.solver.make_solver_trainer`) with
    the mesh sharded over the graph group and trajectories over the data
    group:

    - the normalizers accumulate over the part's ground-truth fields on the
      save grid, their differences over the save grid's first interval and
      the part's own mesh edges, synced over the world in one ``all_reduce``;
    - the solve runs the part's forward with its exchange
      (:func:`shard_forward`); the bounded adaptive Tsit5 sums its error norm
      over the graph group, so every rank takes the same tries;
    - the error terms stay shard-local over the global count of updated
      nodes (summed over the graph group outside autograd), divided by the
      data group's size; MultipleShooting's windows run one after another in
      the same order on every rank, so their exchanges pair up;
    - after ``backward()`` the loss and the gradients are summed over the
      world (one flat ``all_reduce``), and the non-finite guard and the
      ``norm_steps`` gate decide on the sums, so every rank takes or skips
      the same update.

    ``state`` is updated in place and returned; ``losses`` ``(1,)`` f32 on
    the host, the same on every rank."""
    integrate = integrator(strategy, mesh.graph_comm)
    forward = shard_forward(mesh.graph_comm)

    def step(state: TrainState, shard: RankShard) -> Tuple[TrainState, torch.Tensor]:
        g, times = shard.graph, shard.times
        saveat = _save_grid(strategy, times.device)
        node_mask = g.node_mask
        val_mask = (type_mask(g.node_type, types_updated) & node_mask).float()
        inflow_mask = type_mask(g.node_type, types_inflow) & node_mask
        with torch.no_grad():
            gt_fields = {f: shard.fields[f][_save_frames(times, saveat)] for f in spec.fields}
            state.norm = norm = _accumulate(state.norm, spec, gt_fields, node_mask, g.mef,
                                            g.edge_mask, saveat[1] - saveat[0], mesh.world)
            gt = torch.cat([gt_fields[f] for f in spec.target_fields], dim=-1)
            non_target = {f: gt_fields[f][0] for f in spec.fields
                          if f not in spec.target_fields}
            count = mesh.graph_comm.all_reduce(val_mask.sum().reshape(1))
        denom = torch.clamp(count[0] * gt.shape[-1], min=1.0)
        deriv = make_deriv_fn(state.params, model_cfg, norm, g, spec, non_target, val_mask,
                              inflow_mask=inflow_mask, forcing_data=gt, forcing_times=saveat,
                              forward=forward)
        solve = solve_fn(strategy, integrate, deriv, norm, spec, gt, val_mask, denom, saveat,
                         scale=1.0 / mesh.data)
        leaves = param_leaves(state.params)

        def synced(backward: bool) -> torch.Tensor:
            loss = solve(backward)
            if backward:
                _sum_grads(leaves, mesh.world)
            return mesh.world.all_reduce(loss.reshape(1).clone())[0]

        loss = _guarded_step(state, norm_steps, synced)
        return state, loss.reshape(1).float().cpu()

    return step
