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

Not ported yet: graph-parallel cloth training and evaluation
(``graph_parallel > 1`` raises; ROADMAP.md, A7b).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device
from mgn_tpu_torch.checkpoint.manager import CheckpointManager, load_model
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.data.pipeline import Dataset
from mgn_tpu_torch.data.prep import BytesLRU, dataset_buckets, prepare_trajectory
from mgn_tpu_torch.models.mgn_multi import init_mgn_multi
from mgn_tpu_torch.rollout.evaluate import (eval_record, export_rollouts, timed_rollout,
                                            validation_loss)
from mgn_tpu_torch.train.cloth import (ClothConfig, cloth_model_config, make_cloth_norm_state,
                                       make_cloth_rollout, make_cloth_trainer)
from mgn_tpu_torch.train.common import FieldSpec, TrainState, param_leaves, type_mask
from mgn_tpu_torch.train.strategies import DerivativeTraining, get_delta
from mgn_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["is_cloth_meta", "cloth_config", "init_cloth_state", "train_network_cloth",
           "eval_rollouts_cloth", "eval_network_cloth"]

MakeOptimizer = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def is_cloth_meta(meta: Dict[str, Any]) -> bool:
    """True when the dataset declares dynamic world edges (the cloth family)."""
    return bool(meta.get("world_edges"))


def _refuse_graph_parallel(args: Args) -> None:
    if args.graph_parallel > 1:
        raise NotImplementedError("graph-parallel cloth training and evaluation "
                                  "(parallel/cloth.py) is not ported yet (ROADMAP.md, A7b)")


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
    """The cloth twin of ``api.train_network``'s loop, single device.  The
    host RNG draws happen in ``mgn_tpu``'s order (per window the frame
    permutation, then ``rng.integers(2**31)``, which seeds the window's
    noise generator), frames in ``[1, T-1)``, so both packages visit the
    same frames; a window is cut where it would pass the last step."""
    _refuse_graph_parallel(args)
    meta = dataset.meta
    strategy = args.training_strategy
    if not isinstance(strategy, DerivativeTraining):
        raise ValueError("the cloth / world-edge family trains with DerivativeTraining "
                         "(second-order acceleration targets); solver strategies do not "
                         f"apply — got {type(strategy).__name__}")
    node_bucket, edge_bucket = dataset_buckets(dataset, meta, args.node_bucket_multiple,
                                               args.edge_bucket_multiple)
    state, cfg, spec = init_cloth_state(meta, args, make_optimizer, noise, node_bucket, device)
    target = spec.target_fields[0]

    ckpt = CheckpointManager(cp_path)
    rng = np.random.default_rng(args.seed)
    traj_idx = cp_progress = 0
    restored = ckpt.restore(state)
    if restored is not None:
        state, _, host = restored
        if host is not None:
            rng.bit_generator.state = host["rng"]
            traj_idx, cp_progress = host["traj_idx"], host["cp_progress"]
        log.log("resume", step=state.step)
    min_valid = float("inf") if args.reset_valid else ckpt.best_loss()

    trainer = make_cloth_trainer(cfg)
    rollout = make_cloth_rollout(cfg)
    delta = get_delta(strategy, int(meta["trajectory_length"]))
    total_steps = int(args.steps * args.epochs)
    prep_cache = BytesLRU(args.cache_bytes)

    def get_prep(i: int, valid: bool = False):
        i = i % (dataset.num_valid if valid else dataset.num_trajectories)
        return prep_cache.get(("v" if valid else "t", i), lambda: prepare_trajectory(
            dataset.trajectory(i, valid=valid), meta, spec, node_bucket, edge_bucket,
            spatial_reorder=args.spatial_reorder, device=device))

    def sample_perm(prep, k: int) -> np.ndarray:
        # interior frames t in [1, T-1): the second-order target needs both neighbours
        n = prep.num_steps - 2
        if strategy.random:
            return 1 + rng.permutation(n)[:k]
        return 1 + np.arange(min(k, n))

    def valid_sweep() -> float:
        total = 0.0
        with torch.no_grad():
            for i in range(dataset.num_valid):
                prep = get_prep(i, valid=True)
                pred = rollout(state.params, state.norm, prep.template, prep.fields[target],
                               prep.times)
                mask = (type_mask(prep.template.node_type, args.types_updated)
                        & prep.template.node_mask)
                total += float(validation_loss(pred, prep.fields[target], mask))
        loss = total / max(dataset.num_valid, 1)
        log.log("valid", step=state.step, loss=loss)
        return loss

    def host_state() -> Dict[str, Any]:
        return {"rng": rng.bit_generator.state, "traj_idx": traj_idx,
                "cp_progress": cp_progress}

    losses = torch.zeros((0,))  # stays empty if already past total_steps
    t_last = time.time()
    while state.step < total_steps:
        prep = get_prep(traj_idx)
        traj_idx += 1
        perm = sample_perm(prep, max(1, min(delta, total_steps - state.step)))
        gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**31)))
        state, losses = trainer(state, prep.template, prep.fields[target], prep.times, perm,
                                gen)
        cp_progress += len(losses)
        dt_wall = time.time() - t_last
        t_last = time.time()
        log.log("train", step=state.step, loss=float(losses.mean()),
                steps_per_s=len(losses) / max(dt_wall, 1e-9),
                warming_up=bool(state.step <= args.norm_steps))
        if state.step > args.norm_steps and cp_progress >= args.checkpoint:
            cp_progress = 0
            valid_loss = valid_sweep()
            if valid_loss < min_valid:
                min_valid = valid_loss
                ckpt.save(state, valid_loss, best=True, host=host_state())
            ckpt.save(state, float(losses.mean()), host=host_state())
            log.log("checkpoint", step=state.step, valid_loss=valid_loss,
                    min_valid_loss=min_valid)
    if len(losses):  # a resume past completion trains nothing; keep checkpoints
        ckpt.save(state, float(losses.mean()), host=host_state())
    return state, min_valid


def eval_rollouts_cloth(dataset: Dataset, args: Args, cp_path: str, mse_steps,
                        log: MetricsLogger, device: torch.device
                        ) -> Tuple[List[Dict[str, Any]], List[Dict[str, np.ndarray]]]:
    """The rollouts of :func:`eval_network_cloth` on the first
    ``args.num_rollouts`` trajectories of ``dataset`` (the test split), with
    the checkpoint under ``cp_path`` (the best-validation one where
    ``args.use_valid`` and it exists): the semi-implicit integration from
    the first two frames, handle nodes forced from the ground truth.
    Returns the per-trajectory reports and the export records."""
    _refuse_graph_parallel(args)
    meta = dataset.meta
    node_bucket, edge_bucket = dataset_buckets(dataset, meta, args.node_bucket_multiple,
                                               args.edge_bucket_multiple)
    cfg, spec = cloth_config(meta, args, node_bucket=node_bucket)
    target = spec.target_fields[0]
    params, norm = load_model(cp_path, args.use_valid, device)
    rollout = make_cloth_rollout(cfg)
    reports, exports = [], []
    with torch.no_grad():
        for i in range(min(args.num_rollouts, dataset.num_trajectories)):
            traj = dataset.trajectory(i)
            prep = prepare_trajectory(traj, meta, spec, node_bucket, edge_bucket,
                                      spatial_reorder=args.spatial_reorder, device=device)
            pred, secs = timed_rollout(lambda: rollout(params, norm, prep.template,
                                                       prep.fields[target], prep.times),
                                       warm=i == 0 and device.type == "cuda")
            report, record = eval_record(i, traj, prep.unpermute(pred.cpu().numpy()),
                                         prep.unpermute(prep.fields[target].cpu().numpy()),
                                         prep.times.cpu().numpy(), secs, mse_steps, log)
            reports.append(report)
            exports.append(record)
    return reports, exports


def eval_network_cloth(dataset: Dataset, args: Args, cp_path: str, out_path: str, mse_steps,
                       log: MetricsLogger, device: torch.device) -> List[Dict[str, Any]]:
    """The cloth twin of ``eval_network``: :func:`eval_rollouts_cloth`,
    then ``<out_path>/semi_implicit/trajectories.h5`` (``.npz`` where
    ``h5py`` is not installed).  Returns the reports."""
    reports, exports = eval_rollouts_cloth(dataset, args, cp_path, mse_steps, log, device)
    log.log("export", path=export_rollouts(out_path, "semi_implicit", exports))
    return reports
