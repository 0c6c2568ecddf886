"""Top-level API of the port: ``train_network`` (derivative or solver
training, one trajectory a step or B as one disjoint-union graph), ``eval_network``
(rollout error reports and the ``trajectories.h5`` export, or ``.npz``
without ``h5py``), ``simulate``
(serving), ``init_state`` and ``build_model_config`` — the counterparts of
``mgn_tpu/api.py``."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device
from mgn_tpu_torch.api_cloth import eval_rollouts_cloth, is_cloth_meta, train_network_cloth
from mgn_tpu_torch.api_spmd import eval_rollouts_spmd, rank_mesh, simulate_spmd, spmd_training
from mgn_tpu_torch.checkpoint.manager import CheckpointManager, load_model
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.data.meta import load_meta, spatial_dim
from mgn_tpu_torch.data.pipeline import Trajectory, load_dataset
from mgn_tpu_torch.data.prep import BytesLRU, dataset_buckets, prepare_trajectory
from mgn_tpu_torch.models.mgn import MGNConfig, init_mgn
from mgn_tpu_torch.parallel.mesh import is_writer
from mgn_tpu_torch.rollout.evaluate import (enclosing_frames, eval_record, export_rollouts,
                                            make_rollout_fn, save_grid, timed_rollout,
                                            validation_loss)
from mgn_tpu_torch.train.common import (FieldSpec, NormState, TrainState, param_leaves,
                                        type_mask)
from mgn_tpu_torch.data.union import union_prepared
from mgn_tpu_torch.train.derivative import (DerivativeTrainerConfig, make_derivative_trainer,
                                            make_union_derivative_trainer)
from mgn_tpu_torch.train.loop import HostLoop, resume, train_loop
from mgn_tpu_torch.train.solver import SolverTrainerConfig, make_solver_trainer
from mgn_tpu_torch.train.strategies import (DerivativeTraining, MultipleShooting,
                                            SolverTraining, get_delta)
from mgn_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["train_network", "eval_network", "eval_rollouts", "simulate", "build_model_config",
           "init_state"]

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
    """Train a MeshGraphNet on a dataset directory; returns ``(state,
    min_valid_loss)``.  ``training_strategy`` (an :class:`Args` field)
    selects derivative training (:class:`DerivativeTraining`, the default)
    or training through the solver (:class:`SolverTraining`,
    :class:`MultipleShooting`: :func:`make_solver_trainer`, one optimizer
    step a trajectory).  A cloth dataset (meta.json with
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
    (per window ``rng.permutation`` then ``rng.integers(2**31)``; a solver
    step draws the second only, unused, as the JAX package draws a key
    for it), so both packages visit the same frames and trajectories; the
    noise is drawn from a ``torch.Generator`` seeded with the second draw.

    ``batchsize > 1`` trains ``batchsize`` trajectories a step as one
    disjoint-union graph (:func:`mgn_tpu_torch.data.union.union_prepared`):
    derivative training through :func:`make_union_derivative_trainer`, per
    window one permutation per trajectory, stacked to ``(delta, B)``, then
    the noise seed; solver training through the plain solver trainer on
    the union, whose trajectories share one time grid.  A cloth dataset
    trains one trajectory a step with derivative training whatever
    ``batchsize`` says, as in ``mgn_tpu``, and refuses solver strategies.
    """
    dev = resolve_device(device)
    args = Args(**kwargs).resolve_auto()
    log = metrics or MetricsLogger(quiet=True, wandb_logger=args.wandb_logger)
    noise = (tuple(float(x) for x in noise_stddevs)
             if isinstance(noise_stddevs, (tuple, list)) else (float(noise_stddevs),))
    dataset = load_dataset(ds_path, is_training=True)
    meta = dataset.meta
    if is_cloth_meta(meta):  # the cloth / world-edge family: its own trainer and rollout
        return train_network_cloth(dataset, args, make_optimizer, noise[0], cp_path, log, dev)
    strategy = args.training_strategy
    if not isinstance(strategy, (DerivativeTraining, SolverTraining, MultipleShooting)):
        raise ValueError(f"unknown training strategy {strategy!r}")
    mesh = None
    if args.graph_parallel > 1:
        mesh = rank_mesh(args, dev)  # before any tensor: the rank's card
        dev = mesh.device
    state, model_cfg, spec = init_state(meta, args, make_optimizer, dev)
    ckpt = CheckpointManager(cp_path)
    host = HostLoop(np.random.default_rng(args.seed))
    state, min_valid = resume(ckpt, state, host, args, log)
    valid_substeps = _substeps_for(meta, args.solver_valid_dt)

    if mesh is not None:
        window, valid_loss = spmd_training(dataset, meta, args, mesh, model_cfg, spec, noise,
                                           host, valid_substeps)
        return train_loop(state, args, ckpt, min_valid, host, window, valid_loss,
                           dataset.num_valid, log if is_writer() else MetricsLogger(quiet=True),
                           graph_parallel=mesh.graph, batch=mesh.data)
    delta = get_delta(strategy, int(meta["trajectory_length"]))
    node_bucket, edge_bucket = dataset_buckets(dataset, meta, args.node_bucket_multiple,
                                               args.edge_bucket_multiple)
    batch = max(args.batchsize, 1)
    derivative = isinstance(strategy, DerivativeTraining)
    if derivative:
        tcfg = DerivativeTrainerConfig(
            model=model_cfg, spec=spec, noise_stddevs=noise, types_updated=args.types_updated,
            types_noisy=args.types_noisy, norm_steps=args.norm_steps)
        # batch > 1: built at the first union, which gives the node -> graph ids
        trainer = make_derivative_trainer(tcfg) if batch == 1 else None
    else:
        trainer = make_solver_trainer(SolverTrainerConfig(
            model=model_cfg, spec=spec, strategy=strategy, types_updated=args.types_updated,
            types_inflow=args.types_inflow, norm_steps=args.norm_steps))
    rollout_valid = make_rollout_fn(
        model_cfg, spec, solver=args.solver_valid, solver_substeps=valid_substeps,
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

    def sample_perm(prep) -> np.ndarray:
        n_frames = prep.num_steps - 1
        if strategy.random:
            return host.rng.permutation(n_frames)[:delta]
        return np.arange(min(delta, n_frames))

    def window(state: TrainState, steps_left: int):
        nonlocal trainer
        if batch > 1:
            # disjoint-union batching: B graphs -> one graph (data/union.py)
            preps = [get_prep(host.traj_idx + b) for b in range(batch)]
            template, fields, times, info = union_prepared(preps)
        else:
            preps = [get_prep(host.traj_idx)]
            template, fields, times = preps[0].template, preps[0].fields, preps[0].times
        host.traj_idx += batch
        if not derivative:
            host.rng.integers(2**31)  # JAX's unused key: the draws keep its order
            state, losses = trainer(state, template, fields, times)
            return state, losses, 1
        if trainer is None:
            trainer = make_union_derivative_trainer(tcfg, info.node_graph_ids())
        perm = (np.stack([sample_perm(p) for p in preps], 1) if batch > 1  # (delta, B)
                else sample_perm(preps[0]))
        gen = torch.Generator(device=dev).manual_seed(int(host.rng.integers(2**31)))
        state, losses = trainer(state, template, fields, times, perm, gen)
        return state, losses, len(perm)

    def valid_loss(state: TrainState, i: int) -> torch.Tensor:
        prep = get_prep(i, valid=True)
        pred = rollout_valid(state.params, state.norm, prep.template, prep.fields, prep.times)
        gt = torch.cat([prep.fields[f] for f in spec.target_fields], dim=-1)
        mask = type_mask(prep.template.node_type, args.types_updated) & prep.template.node_mask
        return validation_loss(pred, gt, mask)

    return train_loop(state, args, ckpt, min_valid, host, window, valid_loss,
                       dataset.num_valid, log)


def eval_network(
    ds_path: str,
    cp_path: str,
    out_path: str,
    solver: str = "tsit5_adaptive",
    start: Optional[float] = None,
    stop: Optional[float] = None,
    dt: Optional[float] = None,
    saves: Optional[np.ndarray] = None,
    mse_steps: Sequence[int] = (),
    metrics: Optional[MetricsLogger] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs: Any,
) -> List[Dict[str, Any]]:
    """Evaluate a trained network on the test split: :func:`eval_rollouts`,
    then ``<out_path>/<solver name>/trajectories.h5`` (``solver``, or
    ``f"{solver}_dt{dt}"`` with a ``dt``; ``semi_implicit`` for the cloth
    family), logged as an ``export`` record.  Returns the per-trajectory
    reports.

    Where ``h5py`` is not installed (the GPU machine) the export is the same
    arrays as ``trajectories.npz`` (:func:`~mgn_tpu_torch.rollout.evaluate.
    export_rollouts`).  Runs on the GPU (``device=None`` raises without one);
    ``device="cpu"`` runs the plain PyTorch path.
    """
    log = metrics or MetricsLogger(quiet=True)
    reports, exports, solver_name = eval_rollouts(ds_path, cp_path, solver, start, stop, dt,
                                                  saves, mse_steps, log, device, **kwargs)
    if is_writer():
        log.log("export", path=export_rollouts(out_path, solver_name, exports))
    return reports


def eval_rollouts(
    ds_path: str,
    cp_path: str,
    solver: str = "tsit5_adaptive",
    start: Optional[float] = None,
    stop: Optional[float] = None,
    dt: Optional[float] = None,
    saves: Optional[np.ndarray] = None,
    mse_steps: Sequence[int] = (),
    metrics: Optional[MetricsLogger] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs: Any,
) -> Tuple[List[Dict[str, Any]], List[Dict[str, np.ndarray]], str]:
    """The rollouts of :func:`eval_network`, without the export: returns
    ``(reports, export records, solver name)``.

    Rolls out the first ``num_rollouts`` test trajectories with the
    checkpoint under ``cp_path`` (the best-validation one where
    ``use_valid`` and it exists) on the save grid: the data's times, cut to
    ``[start, stop]``, or ``saves``.  Each prediction is held against the
    data frame enclosing each save time and reported by
    :func:`~mgn_tpu_torch.rollout.evaluate.eval_record` (``mse_steps`` its
    horizons), in the dataset's node order.  ``rollout_seconds`` is the host clock around a
    rollout that ends in ``torch.cuda.synchronize()`` on the card (there
    the first trajectory is rolled out once before, untimed), and
    ``steps_per_second`` the save steps over it.  A cloth dataset takes the
    semi-implicit rollout of :func:`mgn_tpu_torch.api_cloth.eval_rollouts_cloth`
    (``solver`` does not apply).  ``kwargs`` are :class:`Args` fields.
    """
    dev = resolve_device(device)
    args = Args(**kwargs).resolve_auto()
    log = metrics or MetricsLogger(quiet=True, wandb_logger=args.wandb_logger)
    dataset = load_dataset(ds_path, is_training=False)
    meta = dataset.meta
    if is_cloth_meta(meta):
        reports, exports = eval_rollouts_cloth(dataset, args, cp_path, mse_steps, log, dev)
        return reports, exports, "semi_implicit"

    model_cfg, spec = build_model_config(meta, args)
    mesh = rank_mesh(args, dev) if args.graph_parallel > 1 else None
    if mesh is not None:
        dev = mesh.device  # the rank's card, before any tensor
    params, norm = load_model(cp_path, args.use_valid, dev)
    if mesh is not None:
        reports, exports = eval_rollouts_spmd(
            dataset, meta, args, mesh, params, norm, model_cfg, spec, solver,
            _substeps_for(meta, dt), start, stop, saves, mse_steps,
            log if is_writer() else MetricsLogger(quiet=True))
        return reports, exports, solver if dt is None else f"{solver}_dt{dt}"
    rollout_fn = make_rollout_fn(
        model_cfg, spec, solver=solver, solver_substeps=_substeps_for(meta, dt),
        types_updated=args.types_updated, types_inflow=args.types_inflow,
        rtol=args.rtol, atol=args.atol)
    node_bucket, edge_bucket = dataset_buckets(dataset, meta, args.node_bucket_multiple,
                                               args.edge_bucket_multiple)
    reports, exports = [], []
    with torch.no_grad():
        for i in range(min(args.num_rollouts, dataset.num_trajectories)):
            traj = dataset.trajectory(i)
            prep = prepare_trajectory(traj, meta, spec, node_bucket, edge_bucket,
                                      spatial_reorder=args.spatial_reorder, device=dev)
            data_t = prep.times.cpu().numpy()
            times = save_grid(data_t, start, stop, saves)
            times_d = torch.as_tensor(times, device=dev)
            pred, secs = timed_rollout(lambda: rollout_fn(params, norm, prep.template,
                                                          prep.fields, times_d, prep.times),
                                       warm=i == 0 and dev.type == "cuda")
            fidx = enclosing_frames(data_t, times)
            gt = torch.cat([prep.fields[f] for f in spec.target_fields], dim=-1)
            report, record = eval_record(i, traj, prep.unpermute(pred.cpu().numpy()),
                                         prep.unpermute(gt.cpu().numpy()[fidx]), times, secs,
                                         mse_steps, log)
            reports.append(report)
            exports.append(record)
    return reports, exports, solver if dt is None else f"{solver}_dt{dt}"


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
    mesh = rank_mesh(args, dev) if args.graph_parallel > 1 else None
    if mesh is not None:
        dev = mesh.device  # the rank's card, before any tensor
    params, norm = load_model(cp_path, args.use_valid, dev)

    traj = Trajectory(
        mesh_pos=np.asarray(mesh_pos, np.float32),
        node_type=np.asarray(node_type, np.int32).reshape(-1),
        times=np.asarray(times[:1], np.float32),
        fields={f: np.asarray(v, np.float32)[None] for f, v in initial_fields.items()},
        cells=None if cells is None else np.asarray(cells, np.int32),
        edges=None if edges is None else np.asarray(edges, np.int32),
    )
    if mesh is not None:
        return simulate_spmd(traj, meta, args, mesh, params, norm, model_cfg, spec, solver, times)
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
