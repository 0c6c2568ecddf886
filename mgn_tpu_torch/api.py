"""Top-level API of the port: ``simulate`` (serving) and
``build_model_config`` — the counterparts of ``mgn_tpu/api.py``.
Training and evaluation entry points come with later slices."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device, tree_to
from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.data.meta import load_meta, spatial_dim
from mgn_tpu_torch.data.pipeline import Trajectory
from mgn_tpu_torch.data.prep import prepare_trajectory
from mgn_tpu_torch.models.mgn import MGNConfig
from mgn_tpu_torch.rollout.evaluate import make_rollout_fn
from mgn_tpu_torch.train.common import FieldSpec

__all__ = ["simulate", "build_model_config"]


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
            "drive and is not served by simulate")

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
