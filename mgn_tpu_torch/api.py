"""Top-level API of the port: ``train_network`` (derivative training),
``simulate`` (serving), ``init_state`` and ``build_model_config`` — the
counterparts of ``mgn_tpu/api.py``.  ``eval_network`` comes with a later
slice (ROADMAP A2)."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device, tree_to
from mgn_tpu_torch.api_cloth import is_cloth_meta, train_network_cloth
from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.data.meta import load_meta, spatial_dim
from mgn_tpu_torch.data.pipeline import Dataset, Trajectory, load_dataset
from mgn_tpu_torch.data.prep import BytesLRU, dataset_buckets, prepare_trajectory
from mgn_tpu_torch.models.mgn import MGNConfig, init_mgn
from mgn_tpu_torch.rollout.evaluate import make_rollout_fn, validation_loss
from mgn_tpu_torch.train.common import (FieldSpec, NormState, TrainState, param_leaves,
                                        type_mask)
from mgn_tpu_torch.train.derivative import DerivativeTrainerConfig, make_derivative_trainer
from mgn_tpu_torch.train.strategies import DerivativeTraining, get_delta
from mgn_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["train_network", "simulate", "build_model_config", "init_state"]

MakeOptimizer = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def build_model_config(meta: Dict[str, Any], args: Args) -> Tuple[MGNConfig, FieldSpec]:
    spec = FieldSpec.from_meta(meta)
    quantities, _, _, _ = N.normalizers_from_meta(meta, args.max_norm_steps)
    cfg = MGNConfig(
        node_input_dim=quantities,
        edge_input_dim=spatial_dim(meta) + 1,
        output_dim=spec.output_dim,
        latent_size=args.layer_size,
        hidden_layers=args.hidden_layers,
        message_passing_steps=args.mps,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
        aggregation_backend=args.aggregation_backend,
        unroll=args.unroll,
        fused=bool(args.fused),
        fused_backward=bool(args.fused_backward),
    )
    return cfg, spec


def init_state(meta: Dict[str, Any], args: Args, make_optimizer: MakeOptimizer,
               device: Optional[Union[str, torch.device]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[TrainState, MGNConfig, FieldSpec]:
    """Fresh :class:`TrainState`: parameters drawn from ``generator``
    (default: seeded with ``args.seed``; the JAX package's ``PRNGKey`` gives
    other numbers), ``make_optimizer`` over :func:`param_leaves` of them,
    normalizers from meta.json, step 0."""
    dev = resolve_device(device)
    cfg, spec = build_model_config(meta, args)
    _, e_norm, n_norms, o_norms = N.normalizers_from_meta(meta, args.max_norm_steps)
    gen = generator if generator is not None else torch.Generator().manual_seed(args.seed)
    params = init_mgn(cfg, gen, device=dev)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    state = TrainState(params=params, optimizer=make_optimizer(leaves),
                       norm=NormState(edge=e_norm, node=n_norms, output=o_norms).to(dev),
                       step=0)
    return state, cfg, spec


def _substeps_for(meta: Dict[str, Any], solver_dt: Optional[float]) -> Optional[int]:
    """Fixed-step substeps per save interval (meta.json dt / solver dt)."""
    if solver_dt is None:
        return None
    base = meta.get("dt")
    if isinstance(base, (int, float)) and solver_dt > 0:
        return max(1, int(round(float(base) / float(solver_dt))))
    return 1


def train_network(
    noise_stddevs: Union[Sequence[float], float],
    make_optimizer: MakeOptimizer,
    ds_path: str,
    cp_path: str,
    metrics: Optional[MetricsLogger] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs: Any,
) -> Tuple[TrainState, float]:
    """Train a MeshGraphNet on a dataset directory with derivative training;
    returns ``(state, min_valid_loss)``.  A cloth dataset (meta.json with
    ``world_edges``) trains the two-edge-set cloth model
    (:func:`mgn_tpu_torch.api_cloth.train_network_cloth`, noise
    ``noise_stddevs``' first entry on the world positions).

    ``make_optimizer`` builds the optimizer from the parameter list, e.g.
    ``lambda ps: torch.optim.Adam(ps, lr=1e-4)``; ``kwargs`` are
    :class:`Args` fields.  Runs on the GPU (``device=None`` raises without
    one); ``device="cpu"`` runs the plain PyTorch path.  Resumes from the
    newest periodic checkpoint under ``cp_path``, with the optimizer state,
    the step and the host loop state (frame RNG, trajectory index), so k + k
    steps equal 2k.  The host RNG draws happen in ``mgn_tpu``'s order
    (per window ``rng.permutation`` then ``rng.integers(2**31)``), so both
    packages visit the same frames; the noise is drawn from a
    ``torch.Generator`` seeded with the second draw.
    """
    dev = resolve_device(device)
    args = Args(**kwargs).resolve_auto()
    log = metrics or MetricsLogger(quiet=True, wandb_logger=args.wandb_logger)
    noise = (tuple(float(x) for x in noise_stddevs)
             if isinstance(noise_stddevs, (tuple, list)) else (float(noise_stddevs),))
    if args.batchsize > 1:
        raise NotImplementedError("batchsize > 1 (the batched and union trainers) is not "
                                  "ported yet (ROADMAP.md, A2.5)")
    dataset = load_dataset(ds_path, is_training=True)
    meta = dataset.meta
    if is_cloth_meta(meta):  # the cloth / world-edge family: its own trainer and rollout
        return train_network_cloth(dataset, args, make_optimizer, noise[0], cp_path, log, dev)
    strategy = args.training_strategy
    if not isinstance(strategy, DerivativeTraining):
        raise NotImplementedError(
            f"{type(strategy).__name__} (backprop through the rollout) is not ported yet "
            "(ROADMAP.md, A3); use DerivativeTraining")
    state, model_cfg, spec = init_state(meta, args, make_optimizer, dev)
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

    delta = get_delta(strategy, int(meta["trajectory_length"]))
    node_bucket, edge_bucket = dataset_buckets(dataset, meta, args.node_bucket_multiple,
                                               args.edge_bucket_multiple)
    trainer = make_derivative_trainer(DerivativeTrainerConfig(
        model=model_cfg, spec=spec, noise_stddevs=noise, types_updated=args.types_updated,
        types_noisy=args.types_noisy, norm_steps=args.norm_steps))
    rollout_valid = make_rollout_fn(
        model_cfg, spec, solver=args.solver_valid,
        solver_substeps=_substeps_for(meta, args.solver_valid_dt),
        types_updated=args.types_updated, types_inflow=args.types_inflow,
        rtol=args.rtol, atol=args.atol)
    # byte-capped LRU: device-resident prepared trajectories never exceed
    # args.cache_bytes; evicted ones are prepared again from the host cache
    prep_cache = BytesLRU(args.cache_bytes)

    def get_prep(i: int, valid: bool = False):
        i = i % (dataset.num_valid if valid else dataset.num_trajectories)
        return prep_cache.get(("v" if valid else "t", i), lambda: prepare_trajectory(
            dataset.trajectory(i, valid=valid), meta, spec, node_bucket, edge_bucket,
            spatial_reorder=args.spatial_reorder, device=dev))

    def host_state() -> Dict[str, Any]:
        return {"rng": rng.bit_generator.state, "traj_idx": traj_idx,
                "cp_progress": cp_progress}

    total_steps = int(args.steps * args.epochs)
    losses = torch.zeros((0,))  # stays empty if already past total_steps
    t_last = time.time()
    while state.step < total_steps:
        prep = get_prep(traj_idx)
        traj_idx += 1
        n_frames = prep.num_steps - 1
        perm = (rng.permutation(n_frames)[:delta] if strategy.random
                else np.arange(min(delta, n_frames)))
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        state, losses = trainer(state, prep.template, prep.fields, prep.times, perm, gen)
        cp_progress += len(perm)
        dt_wall = time.time() - t_last
        t_last = time.time()
        log.log("train", step=state.step, loss=float(losses.mean()),
                steps_per_s=len(perm) / max(dt_wall, 1e-9),
                warming_up=bool(state.step <= args.norm_steps))

        if state.step > args.norm_steps and cp_progress >= args.checkpoint:
            cp_progress = 0
            valid_loss = _validation_sweep(dataset, spec, args, state, rollout_valid, log,
                                           lambda i: get_prep(i, valid=True))
            if valid_loss < min_valid:
                min_valid = valid_loss
                ckpt.save(state, valid_loss, best=True, host=host_state())
            ckpt.save(state, float(losses.mean()), host=host_state())
            log.log("checkpoint", step=state.step, valid_loss=valid_loss,
                    min_valid_loss=min_valid)

    if len(losses):  # a resume past completion trains nothing; keep checkpoints
        ckpt.save(state, float(losses.mean()), host=host_state())
    return state, min_valid


def _validation_sweep(dataset: Dataset, spec: FieldSpec, args: Args, state: TrainState,
                      rollout_fn, log: MetricsLogger, prep_fn) -> float:
    """Rollout-based validation over all valid trajectories: the mean of
    their masked rollout MSEs."""
    total = 0.0
    with torch.no_grad():
        for i in range(dataset.num_valid):
            prep = prep_fn(i)
            pred = rollout_fn(state.params, state.norm, prep.template, prep.fields,
                              prep.times)
            gt = torch.cat([prep.fields[f] for f in spec.target_fields], dim=-1)
            mask = (type_mask(prep.template.node_type, args.types_updated)
                    & prep.template.node_mask)
            total += float(validation_loss(pred, gt, mask))
    loss = total / max(dataset.num_valid, 1)
    log.log("valid", step=state.step, loss=loss)
    return loss


def simulate(
    meta_dir: str,
    cp_path: str,
    mesh_pos: np.ndarray,
    node_type: np.ndarray,
    initial_fields: Dict[str, np.ndarray],  # each (N, dim) — one frame
    times: np.ndarray,  # save grid, times[0] = initial time
    cells: Optional[np.ndarray] = None,
    edges: Optional[np.ndarray] = None,
    solver: str = "euler",
    device: Optional[Union[str, torch.device]] = None,
    **kwargs: Any,
) -> np.ndarray:
    """Pure autoregressive simulation from a single initial frame (serving).

    Needs no dataset: only a checkpoint (the best-validation stream when
    ``use_valid`` and it exists, else the periodic one), the mesh, and one
    frame of every dynamic field.  Inflow nodes evolve by the network like
    all updated nodes.  Returns predictions ``(len(times), N, output_dim)``
    in the caller's node order.  ``kwargs`` are :class:`Args` fields.

    Runs on the GPU (``device=None`` raises without one); ``device="cpu"``
    runs the plain PyTorch path.
    """
    dev = resolve_device(device)
    args = Args(**kwargs).resolve_auto()
    meta = load_meta(meta_dir)
    if meta.get("world_edges"):
        raise ValueError(
            "simulate() integrates first-order NeuralODE dynamics; the "
            "cloth/world-edge family is second-order with a kinematic handle "
            "drive: serve it with mgn_tpu_torch.serve.cloth_simulator")

    model_cfg, spec = build_model_config(meta, args)
    ckpt = CheckpointManager(cp_path)
    best = args.use_valid and ckpt.latest_step(best=True) is not None
    model = ckpt.restore_model(best=best, device=dev)
    if model is None:
        raise FileNotFoundError(f"no checkpoint found under {cp_path}")
    params, norm = tree_to(model["params"], dev), model["norm"]

    traj = Trajectory(
        mesh_pos=np.asarray(mesh_pos, np.float32),
        node_type=np.asarray(node_type, np.int32).reshape(-1),
        times=np.asarray(times[:1], np.float32),
        fields={f: np.asarray(v, np.float32)[None] for f, v in initial_fields.items()},
        cells=None if cells is None else np.asarray(cells, np.int32),
        edges=None if edges is None else np.asarray(edges, np.int32),
    )
    prep = prepare_trajectory(traj, meta, spec, spatial_reorder=args.spatial_reorder,
                              device=dev)
    rollout_fn = make_rollout_fn(
        model_cfg, spec, solver=solver,
        types_updated=args.types_updated, types_inflow=args.types_inflow,
        rtol=args.rtol, atol=args.atol, forced=False)
    with torch.no_grad():
        pred = rollout_fn(params, norm, prep.template, prep.fields,
                          torch.as_tensor(np.asarray(times, np.float32), device=dev),
                          prep.times)
    return prep.unpermute(pred.cpu().numpy())
