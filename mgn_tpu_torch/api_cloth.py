"""The cloth / world-edge family under the top-level API: the port's
``mgn_tpu/api_cloth.py``.

``mgn_tpu_torch.train_network`` dispatches here when meta.json carries a
``world_edges`` key (``data/synthetic.flag_meta`` writes one): the same
orchestration as the single-edge-set loop — normalizer warm-up, resume with
the host loop state (ROADMAP C5), periodic and best-validation checkpoints,
the validation sweep — around the second-order cloth trainer
(:func:`mgn_tpu_torch.train.cloth.make_cloth_trainer`).  The cloth model is
trained by derivative training only (acceleration targets, semi-implicit
rollouts); solver strategies do not apply.  ``mgn_tpu_torch.eval_network``
evaluates it here too (:func:`eval_network_cloth`).

With ``graph_parallel > 1`` both run graph-parallel over a process group of
``graph_parallel`` ranks (``torchrun``, or
:func:`mgn_tpu_torch.parallel.mesh.spawn`): each trajectory's mesh is
partitioned over the ranks (:class:`ClothPlanner`) and trained and rolled
out by :mod:`mgn_tpu_torch.parallel.cloth`; rank 0 alone writes checkpoints,
logs and exports.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device
from mgn_tpu_torch.api_spmd import rank_mesh
from mgn_tpu_torch.checkpoint.manager import CheckpointManager, load_model
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.core.graph import cells_to_edges, parse_edges
from mgn_tpu_torch.data.meta import node_type_range
from mgn_tpu_torch.data.pipeline import Dataset
from mgn_tpu_torch.data.prep import BytesLRU, dataset_buckets, prepare_trajectory
from mgn_tpu_torch.models.mgn_multi import init_mgn_multi
from mgn_tpu_torch.parallel.cloth import (make_sharded_cloth_rollout, make_sharded_cloth_trainer,
                                          partition_field_stack)
from mgn_tpu_torch.parallel.halo import ShardGraph, shard_graph
from mgn_tpu_torch.parallel.mesh import DeviceMesh, is_writer
from mgn_tpu_torch.parallel.partition import PartitionedTemplate, partition_template
from mgn_tpu_torch.parallel.rollout import gather_prediction, unpermute_sharded
from mgn_tpu_torch.rollout.evaluate import (eval_record, export_rollouts, timed_rollout,
                                            validation_loss)
from mgn_tpu_torch.train.cloth import (ClothConfig, cloth_model_config, make_cloth_norm_state,
                                       make_cloth_rollout, make_cloth_trainer)
from mgn_tpu_torch.train.common import FieldSpec, TrainState, param_leaves, type_mask
from mgn_tpu_torch.train.loop import HostLoop, resume, train_loop
from mgn_tpu_torch.train.strategies import DerivativeTraining, get_delta
from mgn_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["is_cloth_meta", "cloth_config", "init_cloth_state", "train_network_cloth",
           "eval_rollouts_cloth", "eval_network_cloth", "ClothPart", "ClothPlanner"]

MakeOptimizer = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def is_cloth_meta(meta: Dict[str, Any]) -> bool:
    """True when the dataset declares dynamic world edges (the cloth family)."""
    return bool(meta.get("world_edges"))


def _world_capacity(meta: Dict[str, Any], args: Args, node_bucket: int) -> int:
    """The static world-edge buffer size: ``args.world_capacity``, else the
    meta's ``capacity``, else ``capacity_per_node`` (4) times the padded
    nodes, at least 512 and rounded up to a multiple of 128."""
    if args.world_capacity is not None:
        return int(args.world_capacity)
    we = meta.get("world_edges") or {}
    if "capacity" in we:
        return int(we["capacity"])
    cap = max(512, int(we.get("capacity_per_node", 4)) * int(node_bucket))
    return -(-cap // 128) * 128


def cloth_config(meta: Dict[str, Any], args: Args, noise: float = 0.0,
                 node_bucket: int = 128) -> Tuple[ClothConfig, FieldSpec]:
    """The :class:`ClothConfig` and :class:`FieldSpec` of a cloth dataset
    under ``args`` (world-edge capacity from ``node_bucket``)."""
    spec = FieldSpec.from_meta(meta)
    if len(spec.target_fields) != 1:
        raise ValueError("the cloth family expects exactly one target field (world "
                         f"positions); got {spec.target_fields}")
    mcfg = cloth_model_config(
        meta, latent=args.layer_size, hidden_layers=args.hidden_layers, mps=args.mps,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
        aggregation_backend=args.aggregation_backend, fused=bool(args.fused),
        fused_backward=bool(args.fused_backward))
    we = meta.get("world_edges") or {}
    cfg = ClothConfig(model=mcfg, world_radius=float(we.get("radius", 0.05)),
                      world_capacity=_world_capacity(meta, args, node_bucket),
                      noise_stddev=float(noise), types_updated=tuple(args.types_updated),
                      types_noisy=tuple(args.types_noisy), norm_steps=args.norm_steps,
                      world_dim=int(meta.get("world_dim", 3)))
    return cfg, spec


def init_cloth_state(meta: Dict[str, Any], args: Args, make_optimizer: MakeOptimizer,
                     noise: float = 0.0, node_bucket: int = 128,
                     device: Optional[torch.device] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[TrainState, ClothConfig, FieldSpec]:
    """A fresh cloth :class:`TrainState` (parameters drawn from
    ``generator``, default seeded with ``args.seed``; ``make_optimizer``
    over :func:`param_leaves` of them; empty Online normalizers; step 0),
    its :class:`ClothConfig` and :class:`FieldSpec`, on ``device`` (None:
    the GPU)."""
    cfg, spec = cloth_config(meta, args, noise, node_bucket)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(args.seed)
    params = init_mgn_multi(cfg.model, gen, device=dev)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    state = TrainState(params=params, optimizer=make_optimizer(leaves),
                       norm=make_cloth_norm_state(cfg).to(dev), step=0)
    return state, cfg, spec


def train_network_cloth(dataset: Dataset, args: Args, make_optimizer: MakeOptimizer,
                        noise: float, cp_path: str, log: MetricsLogger,
                        device: torch.device) -> Tuple[TrainState, float]:
    """The cloth twin of ``api.train_network``, on one device or, with
    ``graph_parallel > 1``, over a process group of ``graph_parallel``
    ranks (each trajectory's mesh partitioned over them: :class:`ClothPlanner`,
    :func:`mgn_tpu_torch.parallel.cloth.make_sharded_cloth_trainer`; the
    world-edge capacity per part is the global one, as world edges cluster:
    a share of it could drop a part's edges that the whole buffer keeps).
    The loop is ``train.loop.train_loop``.  The host RNG draws happen in
    ``mgn_tpu``'s order (per window the frame permutation, then
    ``rng.integers(2**31)``, which seeds the window's noise generator,
    ``seed * P + g`` on graph rank ``g``), frames in ``[1, T-1)``, so both
    packages visit the same frames; a window is cut where it would pass the
    last step."""
    meta = dataset.meta
    strategy = args.training_strategy
    if not isinstance(strategy, DerivativeTraining):
        raise ValueError("the cloth / world-edge family trains with DerivativeTraining "
                         "(second-order acceleration targets); solver strategies do not "
                         f"apply — got {type(strategy).__name__}")
    mesh = _cloth_mesh(args, device)  # before any tensor: the rank's card
    if mesh is not None:
        device = mesh.device
    node_bucket, edge_bucket = dataset_buckets(dataset, meta, args.node_bucket_multiple,
                                               args.edge_bucket_multiple)
    state, cfg, spec = init_cloth_state(meta, args, make_optimizer, noise, node_bucket, device)
    target = spec.target_fields[0]
    ckpt = CheckpointManager(cp_path)
    host = HostLoop(np.random.default_rng(args.seed))
    state, min_valid = resume(ckpt, state, host, args, log)
    delta = get_delta(strategy, int(meta["trajectory_length"]))

    def sample_perm(num_steps: int, k: int) -> np.ndarray:
        # interior frames t in [1, T-1): the second-order target needs both neighbours
        n = num_steps - 2
        if strategy.random:
            return 1 + host.rng.permutation(n)[:k]
        return 1 + np.arange(min(k, n))

    if mesh is not None:
        comm = mesh.graph_comm
        planner = ClothPlanner(dataset, args, spec, comm, device)
        trainer = make_sharded_cloth_trainer(comm, cfg, cfg.world_capacity)
        rollout = make_sharded_cloth_rollout(comm, cfg, cfg.world_capacity)

        def window(state: TrainState, steps_left: int):
            part = planner.get(host.traj_idx)
            host.traj_idx += 1
            perm = sample_perm(part.world_pos.shape[0], max(1, min(delta, steps_left)))
            seed = int(host.rng.integers(2**31)) * comm.size + comm.rank
            gen = torch.Generator(device=device).manual_seed(seed)
            state, losses = trainer(state, part.shard, part.world_pos, part.times, perm, gen)
            return state, losses, len(losses)

        def valid_loss(state: TrainState, i: int) -> torch.Tensor:
            part = planner.get(i, valid=True)
            pred = rollout(state.params, state.norm, part.shard, part.world_pos, part.times)
            mask = type_mask(part.shard.node_type, args.types_updated) & part.shard.node_mask
            return validation_loss(pred, part.world_pos, mask, comm)

        return train_loop(state, args, ckpt, min_valid, host, window, valid_loss,
                          dataset.num_valid, log if is_writer() else MetricsLogger(quiet=True),
                          graph_parallel=comm.size)

    trainer = make_cloth_trainer(cfg)
    rollout = make_cloth_rollout(cfg)
    prep_cache = BytesLRU(args.cache_bytes)

    def get_prep(i: int, valid: bool = False):
        i = i % (dataset.num_valid if valid else dataset.num_trajectories)
        return prep_cache.get(("v" if valid else "t", i), lambda: prepare_trajectory(
            dataset.trajectory(i, valid=valid), meta, spec, node_bucket, edge_bucket,
            spatial_reorder=args.spatial_reorder, device=device))

    def window(state: TrainState, steps_left: int):
        prep = get_prep(host.traj_idx)
        host.traj_idx += 1
        perm = sample_perm(prep.num_steps, max(1, min(delta, steps_left)))
        gen = torch.Generator(device=device).manual_seed(int(host.rng.integers(2**31)))
        state, losses = trainer(state, prep.template, prep.fields[target], prep.times, perm,
                                gen)
        return state, losses, len(losses)

    def valid_loss(state: TrainState, i: int) -> torch.Tensor:
        prep = get_prep(i, valid=True)
        pred = rollout(state.params, state.norm, prep.template, prep.fields[target],
                       prep.times)
        mask = type_mask(prep.template.node_type, args.types_updated) & prep.template.node_mask
        return validation_loss(pred, prep.fields[target], mask)

    return train_loop(state, args, ckpt, min_valid, host, window, valid_loss,
                      dataset.num_valid, log)


def eval_rollouts_cloth(dataset: Dataset, args: Args, cp_path: str, mse_steps,
                        log: MetricsLogger, device: torch.device
                        ) -> Tuple[List[Dict[str, Any]], List[Dict[str, np.ndarray]]]:
    """The rollouts of :func:`eval_network_cloth` on the first
    ``args.num_rollouts`` trajectories of ``dataset`` (the test split), with
    the checkpoint under ``cp_path`` (the best-validation one where
    ``args.use_valid`` and it exists): the semi-implicit integration from
    the first two frames, handle nodes forced from the ground truth.  With
    ``graph_parallel > 1`` each trajectory is rolled out partitioned over
    the ranks (:func:`mgn_tpu_torch.parallel.cloth.make_sharded_cloth_rollout`)
    and every rank gathers the whole prediction (one ``all_gather``) and
    builds the same reports.  Returns the per-trajectory reports and the
    export records, in the dataset's node order."""
    mesh = _cloth_mesh(args, device)  # before any tensor: the rank's card
    if mesh is not None:
        device = mesh.device
        if not is_writer():
            log = MetricsLogger(quiet=True)
    meta = dataset.meta
    node_bucket, edge_bucket = dataset_buckets(dataset, meta, args.node_bucket_multiple,
                                               args.edge_bucket_multiple)
    cfg, spec = cloth_config(meta, args, node_bucket=node_bucket)
    target = spec.target_fields[0]
    params, norm = load_model(cp_path, args.use_valid, device)
    if mesh is not None:
        comm = mesh.graph_comm
        planner = ClothPlanner(dataset, args, spec, comm, device)
        sharded = make_sharded_cloth_rollout(comm, cfg, cfg.world_capacity)
    else:
        rollout = make_cloth_rollout(cfg)
    reports, exports = [], []
    with torch.no_grad():
        for i in range(min(args.num_rollouts, dataset.num_trajectories)):
            traj = dataset.trajectory(i)
            warm = i == 0 and device.type == "cuda"
            if mesh is not None:
                part = planner.get(i)
                pred, secs = timed_rollout(lambda: sharded(params, norm, part.shard,
                                                           part.world_pos, part.times),
                                           warm=warm)
                pred = unpermute_sharded(part.pt, gather_prediction(pred, comm), traj.num_nodes)
                gt, times = np.asarray(traj.fields[target], np.float32), part.times
            else:
                prep = prepare_trajectory(traj, meta, spec, node_bucket, edge_bucket,
                                          spatial_reorder=args.spatial_reorder, device=device)
                pred, secs = timed_rollout(lambda: rollout(params, norm, prep.template,
                                                           prep.fields[target], prep.times),
                                           warm=warm)
                pred = prep.unpermute(pred.cpu().numpy())
                gt, times = prep.unpermute(prep.fields[target].cpu().numpy()), prep.times
            report, record = eval_record(i, traj, pred, gt, times.cpu().numpy(), secs,
                                         mse_steps, log)
            reports.append(report)
            exports.append(record)
    return reports, exports


def eval_network_cloth(dataset: Dataset, args: Args, cp_path: str, out_path: str, mse_steps,
                       log: MetricsLogger, device: torch.device) -> List[Dict[str, Any]]:
    """The cloth twin of ``eval_network``: :func:`eval_rollouts_cloth`,
    then ``<out_path>/semi_implicit/trajectories.h5`` (``.npz`` where
    ``h5py`` is not installed).  Returns the reports."""
    reports, exports = eval_rollouts_cloth(dataset, args, cp_path, mse_steps, log, device)
    if is_writer():
        log.log("export", path=export_rollouts(out_path, "semi_implicit", exports))
    return reports


class ClothPart(NamedTuple):
    """One trajectory's part on this rank: the partition, the part's static
    structure (the ``"gather"`` :class:`~mgn_tpu_torch.parallel.halo.ShardGraph`), its rows
    of the world positions ``(T, N_p, 3)`` and the frame times ``(T,)``."""

    pt: PartitionedTemplate
    shard: ShardGraph
    world_pos: torch.Tensor
    times: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.shard.nbytes + (self.world_pos.numel() + self.times.numel()) * 4


class ClothPlanner:
    """Each trajectory's cloth partition and this rank's part, cached for
    the planner's lifetime in a byte-capped LRU of ``args.cache_bytes`` on
    the rank's device (the JAX package's ``_ClothPlanner``): trajectory
    ``i`` of ``dataset``'s split, or of its validation split with
    ``valid=True``."""

    def __init__(self, dataset: Dataset, args: Args, spec: FieldSpec, comm, device):
        self.dataset, self.spec, self.comm, self.device = dataset, spec, comm, device
        self.type_range = node_type_range(dataset.meta)
        self.cache = BytesLRU(args.cache_bytes)

    def get(self, i: int, valid: bool = False) -> ClothPart:
        n = self.dataset.num_valid if valid else self.dataset.num_trajectories
        i = i % n

        def build() -> ClothPart:
            tr = self.dataset.trajectory(i, valid=valid)
            s, r = cells_to_edges(tr.cells) if tr.cells is not None else parse_edges(tr.edges)
            pt = partition_template(tr.mesh_pos, tr.node_type, s, r, self.comm.size,
                                    type_min=self.type_range[0], type_max=self.type_range[1])
            wp = partition_field_stack(pt, np.asarray(tr.fields[self.spec.target_fields[0]],
                                                      np.float32))[:, self.comm.rank]
            return ClothPart(pt, shard_graph(pt, self.comm.rank, "gather", self.device),
                             torch.as_tensor(np.ascontiguousarray(wp)).to(self.device),
                             torch.as_tensor(np.asarray(tr.times, np.float32)).to(self.device))
        return self.cache.get(("v" if valid else "t", i), build)


def _cloth_mesh(args: Args, device: torch.device) -> Optional[DeviceMesh]:
    """This rank's (1, graph_parallel) mesh where ``graph_parallel > 1``
    (the cloth family trains one trajectory a step, whatever ``batchsize``
    says), else None."""
    if args.graph_parallel <= 1:
        return None
    return rank_mesh(dataclasses.replace(args, batchsize=1), device)
