"""Graph-parallel training, evaluation and serving of the single-edge-set
model: the port's ``_GraphPlanner``, ``_train_network_spmd``,
``_eval_network_spmd`` and ``_simulate_spmd`` of ``mgn_tpu/api.py``.

``train_network``, ``eval_network`` and ``simulate`` come here where
``graph_parallel > 1``.  Each rank is a process of its own and calls the
entry point with the same arguments, inside a process group of
``batchsize x graph_parallel`` ranks (``torchrun --nproc-per-node N``, or
:func:`mgn_tpu_torch.parallel.mesh.spawn`); the group's backend is the one
it was initialized with (NCCL where every rank has a GPU of its own, gloo on
the CPU and where ranks share a card).  Rank ``d * graph_parallel + g``
holds part ``g`` of trajectory ``d`` of each training group; evaluation,
validation and serving roll every trajectory out on each data coordinate
alike.  Rank 0 alone writes checkpoints, logs and exports; every rank
returns the same values.

The exchange follows ``halo_rounds`` (resolved to ``mps``): the k-deep ghost
zone with ``halo_rounds`` rounds per exchange (it must divide ``mps``), or
with ``halo_rounds=0`` the classic per-round halo.  ``telescope_stages``
above 1 splits each deep segment's rounds into that many near-equal stages
(at most ``halo_rounds``), the later ones on shrinking tables
(``add_deep_halo_plan(telescope=)``); it does nothing without a deep plan.
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mgn_tpu_torch.config import Args
from mgn_tpu_torch.core.graph import cells_to_edges, parse_edges
from mgn_tpu_torch.data.meta import node_type_range
from mgn_tpu_torch.data.pipeline import Trajectory
from mgn_tpu_torch.data.prep import BytesLRU
from mgn_tpu_torch.parallel.mesh import DeviceMesh, is_writer, make_device_mesh
from mgn_tpu_torch.parallel.halo import ShardGraph, shard_graph
from mgn_tpu_torch.parallel.partition import (PartitionedTemplate, add_deep_halo_plan,
                                              add_halo_plan, partition_template)
from mgn_tpu_torch.parallel.rollout import (gather_prediction, make_sharded_rollout_fn,
                                            unpermute_sharded)
from mgn_tpu_torch.parallel.spmd import (RankShard, make_spmd_derivative_step,
                                         make_spmd_solver_step, partition_stack)
from mgn_tpu_torch.rollout.evaluate import (enclosing_frames, eval_record, save_grid,
                                            timed_rollout)
from mgn_tpu_torch.train.common import FieldSpec, TrainState
from mgn_tpu_torch.train.strategies import DerivativeTraining, get_delta
from mgn_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["GraphPlanner", "check_graph_parallel", "rank_mesh", "is_writer", "telescope_split",
           "spmd_training",
           "eval_rollouts_spmd", "simulate_spmd"]


def check_graph_parallel(args: Args) -> None:
    """Refuse a graph-parallel call this process cannot run: ``halo_rounds``
    must divide ``mps``, and a process group of ``batchsize x
    graph_parallel`` ranks must be initialized (``ValueError`` naming
    torchrun where there is none of that size)."""
    if args.halo_rounds and args.mps % args.halo_rounds:
        raise ValueError(f"halo_rounds {args.halo_rounds} must divide mps {args.mps}")
    B, P = max(args.batchsize, 1), args.graph_parallel
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if world != B * P:
        raise ValueError(
            f"graph_parallel={P} with batchsize={B} needs a process group of {B * P} ranks "
            f"(found {world or 'none'}): launch one process per rank, e.g. torchrun "
            f"--nproc-per-node {B * P} -m mgn_tpu_torch train ... --graph-parallel {P}, "
            "or initialize one (mgn_tpu_torch.parallel.mesh.initialize_multihost)")


def rank_mesh(args: Args, device: torch.device) -> DeviceMesh:
    """This rank's (batchsize, graph_parallel) mesh over the initialized
    process group (:func:`check_graph_parallel` first), built once per
    process group (:func:`~mgn_tpu_torch.parallel.mesh.make_device_mesh`).
    A CUDA ``device`` without an index becomes ``cuda:LOCAL_RANK`` and the
    current device; the entry points call this before they make any tensor
    and put the model on ``mesh.device``."""
    check_graph_parallel(args)
    B, P = max(args.batchsize, 1), args.graph_parallel
    return make_device_mesh(B, P, dist.get_backend(), device)


def _edges_of(traj) -> Tuple[np.ndarray, np.ndarray]:
    return cells_to_edges(traj.cells) if traj.cells is not None else parse_edges(traj.edges)


def _topology_key(traj) -> str:
    """A digest of what a trajectory's partition depends on: its positions,
    node types and cells (or edges)."""
    h = hashlib.blake2b(digest_size=16)
    conn = traj.cells if traj.cells is not None else traj.edges
    for a in (traj.mesh_pos, traj.node_type, conn):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    h.update(b"cells" if traj.cells is not None else b"edges")
    return h.hexdigest()


# each mesh's parts, kept while the mesh lives (it lives as long as its process group)
_PARTS: "weakref.WeakKeyDictionary[DeviceMesh, BytesLRU]" = weakref.WeakKeyDictionary()


class GraphPlanner:
    """Partitioning and exchange planning for the graph-parallel paths, one
    trajectory at a time.

    This rank's part of a mesh (its :class:`~mgn_tpu_torch.parallel.halo.
    ShardGraph` and the partition) is kept for the device mesh's lifetime,
    keyed by the mesh's content and the exchange, so a later call on the
    same mesh (a server's next ``simulate`` request, the next evaluation)
    partitions and plans nothing.  A call's trajectories (the part's rows of
    every field) are cached under the caller's keys for the planner's
    lifetime.  Both caches are byte-capped LRUs of ``args.cache_bytes`` on
    the rank's device (the parts' cap is the first planner's on a mesh).

    The JAX planner fixes shared capacities across trajectories from a probe
    and regrows them (``_grow``), because XLA compiles one program for
    static shapes and the TPU kernels for fixed bands.  Nothing here
    compiles per shape: each trajectory is sized alone (its own part
    buckets, halo size and deep-table sizes)."""

    def __init__(self, meta: Dict[str, Any], args: Args, mesh: DeviceMesh):
        self.meta, self.args, self.mesh = meta, args, mesh
        self.rounds = int(args.halo_rounds or 0)
        self.exchange = "deep" if self.rounds else "halo"
        self.telescope = telescope_split(self.rounds, args.telescope_stages)
        self.parts = _PARTS.setdefault(mesh, BytesLRU(args.cache_bytes))
        self.cache = BytesLRU(args.cache_bytes)

    def plan(self, traj) -> PartitionedTemplate:
        """The trajectory's partition (bisection refined) with its exchange
        plan."""
        s, r = _edges_of(traj)
        tmin, tmax = node_type_range(self.meta)
        pt = partition_template(traj.mesh_pos, traj.node_type, s, r, self.mesh.graph,
                                type_min=tmin, type_max=tmax)
        if self.rounds:
            return dataclasses.replace(pt, deep=add_deep_halo_plan(
                pt, traj.mesh_pos, s, r, self.rounds, self.args.mps, telescope=self.telescope))
        return add_halo_plan(pt)

    def part(self, traj) -> Tuple[ShardGraph, PartitionedTemplate]:
        """This rank's part of ``traj``'s mesh on its device and the
        partition, planned once per mesh content and exchange."""
        key = (self.rounds, self.telescope, self.args.mps, node_type_range(self.meta),
               _topology_key(traj))

        def build():
            pt = self.plan(traj)
            return shard_graph(pt, self.mesh.graph_rank, self.exchange, self.mesh.device), pt
        return self.parts.get(key, build)

    def shard(self, key, traj) -> Tuple[RankShard, PartitionedTemplate]:
        """This rank's part of ``traj`` with its rows of every field
        (cached under ``key``) and the partition."""
        def build():
            graph, pt = self.part(traj)
            dev, g = self.mesh.device, self.mesh.graph_rank
            fields = {f: torch.as_tensor(partition_stack(pt, np.asarray(v, np.float32))[g])
                      .to(dev) for f, v in traj.fields.items()}
            times = torch.as_tensor(np.asarray(traj.times, np.float32)).to(dev)
            return RankShard(graph, fields, times), pt
        return self.cache.get(key, build)


def telescope_split(rounds: int, stages: Optional[int]) -> Optional[Tuple[int, ...]]:
    """The deep segment's ``rounds`` split into ``min(stages, rounds)``
    near-equal telescope stages, the longer ones first (``mgn_tpu/api.py``'s
    rule): ``(5, 5, 5)`` for 15 rounds in 3.  None without a deep plan
    (``rounds`` 0) or with fewer than two stages."""
    if not rounds or not stages or stages <= 1:
        return None
    n = min(int(stages), rounds)
    base, rem = divmod(rounds, n)
    return tuple(base + (1 if i < rem else 0) for i in range(n))


def spmd_training(dataset, meta: Dict[str, Any], args: Args, mesh: DeviceMesh, model_cfg,
                  spec: FieldSpec, noise: Tuple[float, ...], host,
                  valid_substeps: Optional[int]) -> Tuple[Callable, Callable]:
    """Graph-parallel training (``_train_network_spmd``): the window and
    the validation loss that ``train_network``'s loop runs.

    A window is one trajectory per data coordinate, partitioned over the
    graph ranks.  Derivative training runs ``delta`` steps cut to the steps
    left (the JAX loop's exact step count); ``host.rng`` draws one
    permutation per trajectory, then the window's noise seed: the
    single-device loop's order (the JAX graph-parallel loop draws the seed
    first), so a graph-parallel and a single-device run visit the same
    frames.  Solver strategies (``SolverTraining``, ``MultipleShooting``)
    run one optimizer step a window (:func:`~mgn_tpu_torch.parallel.spmd.
    make_spmd_solver_step`), drawing the one unused integer the JAX loop
    draws as a key.  A validation trajectory's loss is its sharded
    rollout's through ``args.solver_valid``, summed over the graph group."""
    B = mesh.data
    planner = GraphPlanner(meta, args, mesh)
    strategy = args.training_strategy
    if isinstance(strategy, DerivativeTraining):
        step_fn = make_spmd_derivative_step(mesh, model_cfg, spec, noise, args.types_updated,
                                            args.types_noisy, args.norm_steps)
        solver_step = None
    else:
        solver_step = make_spmd_solver_step(mesh, model_cfg, spec, strategy,
                                            args.types_updated, args.types_inflow,
                                            args.norm_steps)
    rollout_valid = make_sharded_rollout_fn(
        mesh.graph_comm, model_cfg, spec, solver=args.solver_valid,
        solver_substeps=valid_substeps, types_updated=args.types_updated,
        types_inflow=args.types_inflow, rtol=args.rtol, atol=args.atol)
    delta = get_delta(strategy, int(meta["trajectory_length"]))
    n_train = dataset.num_trajectories

    def window(state: TrainState, steps_left: int):
        idxs = [(host.traj_idx + b) % n_train for b in range(B)]
        host.traj_idx += B
        d = mesh.data_rank
        shard, _ = planner.shard(("t", idxs[d]), dataset.trajectory(idxs[d]))
        if solver_step is not None:
            host.rng.integers(2**31)  # JAX's unused key: the draws keep its order
            state, losses = solver_step(state, shard)
            return state, losses, 1
        n_frames = [len(dataset.trajectory(i).times) - 1 for i in idxs]
        k = max(1, min(delta, min(n_frames), steps_left))
        if strategy.random:
            perms = np.stack([host.rng.permutation(nf)[:delta] for nf in n_frames], 1)[:k]
        else:
            perms = np.tile(np.arange(k)[:, None], (1, B))
        state, losses = step_fn(state, shard, perms, int(host.rng.integers(2**31)))
        return state, losses, len(losses)

    def valid_loss(state: TrainState, i: int) -> torch.Tensor:
        shard, _ = planner.shard(("v", i), dataset.trajectory(i, valid=True))
        return rollout_valid(state.params, state.norm, shard.graph, shard.fields,
                             shard.times)[1]

    return window, valid_loss


def eval_rollouts_spmd(dataset, meta: Dict[str, Any], args: Args, mesh: DeviceMesh, params,
                       norm, model_cfg, spec: FieldSpec, solver: str,
                       substeps: Optional[int], start, stop, saves, mse_steps: Sequence[int],
                       log: MetricsLogger
                       ) -> Tuple[List[Dict[str, Any]], List[Dict[str, np.ndarray]]]:
    """The graph-parallel rollouts of ``eval_rollouts`` (``_eval_network_spmd``):
    each test trajectory partitioned over the graph ranks and rolled out
    sharded; every rank gathers the whole prediction (one ``all_gather``),
    un-permuted to the dataset's node order, and builds the same reports.
    ``substeps``: the fixed-step solver's steps per save interval."""
    planner = GraphPlanner(meta, args, mesh)
    rollout_fn = make_sharded_rollout_fn(
        mesh.graph_comm, model_cfg, spec, solver=solver, solver_substeps=substeps,
        types_updated=args.types_updated, types_inflow=args.types_inflow, rtol=args.rtol,
        atol=args.atol)
    reports, exports = [], []
    with torch.no_grad():
        for i in range(min(args.num_rollouts, dataset.num_trajectories)):
            traj = dataset.trajectory(i)
            shard, pt = planner.shard(("t", i), traj)
            data_t = np.asarray(traj.times, np.float32)
            times = save_grid(data_t, start, stop, saves)
            times_d = torch.as_tensor(times, device=mesh.device)
            pred, secs = timed_rollout(
                lambda: rollout_fn(params, norm, shard.graph, shard.fields, times_d,
                                   shard.times)[0],
                warm=i == 0 and mesh.device.type == "cuda")
            pred_u = unpermute_sharded(pt, gather_prediction(pred, mesh.graph_comm),
                                       traj.num_nodes)
            gt = np.concatenate([traj.fields[f] for f in spec.target_fields],
                                -1)[enclosing_frames(data_t, times)]
            report, record = eval_record(i, traj, pred_u, gt, times, secs, mse_steps, log)
            reports.append(report)
            exports.append(record)
    return reports, exports


def simulate_spmd(traj: Trajectory, meta: Dict[str, Any], args: Args, mesh: DeviceMesh,
                  params, norm, model_cfg, spec: FieldSpec, solver: str,
                  times: np.ndarray) -> np.ndarray:
    """Graph-parallel serving (``_simulate_spmd``): the caller's mesh
    partitioned over the graph ranks, rolled out from one frame without
    inflow forcing; every rank returns the whole prediction ``(len(times),
    N, output_dim)`` in the caller's node order.  The mesh's partition is
    planned at its first request and reused by later ones
    (:class:`GraphPlanner`)."""
    shard, pt = GraphPlanner(meta, args, mesh).shard("serve", traj)
    rollout_fn = make_sharded_rollout_fn(
        mesh.graph_comm, model_cfg, spec, solver=solver, types_updated=args.types_updated,
        types_inflow=args.types_inflow, rtol=args.rtol, atol=args.atol, forced=False)
    with torch.no_grad():
        pred, _ = rollout_fn(params, norm, shard.graph, shard.fields,
                             torch.as_tensor(np.asarray(times, np.float32), device=mesh.device),
                             shard.times)
    return unpermute_sharded(pt, gather_prediction(pred, mesh.graph_comm), traj.num_nodes)
