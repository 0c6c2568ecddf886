"""Multi-rank CylinderFlow training: the twin of
``examples/multihost_cylinder/multihost_cylinder.py`` (BASELINE.json config
5) over ``torch.distributed``.

The SPMD derivative path: a (data, graph) mesh of ranks, trajectories spread
over ``data``, each mesh partitioned over ``graph`` (recursive coordinate
bisection, the classic per-round halo exchange), the gradients and the
online normalizers' statistics summed over the world.  One process a rank,
launched by torchrun:

    torchrun --nproc-per-node N -m mgn_tpu_torch.examples.multihost_cylinder \\
        <ds_path> [graph_axis] [--dist-backend nccl|gloo] [--device cuda|cpu]

``graph_axis`` fixes the graph axis (default: the largest power of two that
divides the rank count).  ``--dist-backend`` (default ``nccl``, a GPU a
rank) is gloo where the ranks share one card and on the CPU
(``--device cpu``).  Without torchrun it runs as one rank, mesh (1, 1).

Each trajectory group is partitioned once; each window is one
:func:`~mgn_tpu_torch.parallel.spmd.make_spmd_derivative_step` call of up to
:data:`WINDOW` frames drawn from ``np.random.default_rng(0)``, logged as a
``train`` line (:class:`~mgn_tpu_torch.utils.metrics.MetricsLogger`).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import cells_to_edges
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.models.mgn import MGNConfig, init_mgn
from mgn_tpu_torch.parallel.mesh import (BACKENDS, initialize_multihost, make_device_mesh,
                                         mesh_shape_for)
from mgn_tpu_torch.parallel.partition import add_halo_plan, partition_template
from mgn_tpu_torch.parallel.spmd import batch_from_partitioned, make_spmd_derivative_step
from mgn_tpu_torch.train.common import FieldSpec, NormState, TrainState, param_leaves
from mgn_tpu_torch.utils.metrics import MetricsLogger

# the JAX example's sizes (a test shrinks them here)
LATENT, HIDDEN, MPS = 128, 2, 15
NOISE, NORM_STEPS, LR = 0.02, 100, 1e-4
WINDOW, FRAMES = 32, 1000  # frames a window; FRAMES // WINDOW windows


def initial_params(cfg: MGNConfig, device: torch.device) -> Dict[str, Any]:
    """The model's first parameters (seed 0; ``jax.random.PRNGKey(0)``
    draws other numbers)."""
    return init_mgn(cfg, torch.Generator().manual_seed(0), device=device)


def _process_group(backend: str) -> None:
    """torchrun's process group, or one of a single rank without torchrun."""
    if not initialize_multihost(backend):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def main(argv=None) -> Tuple[TrainState, List[np.ndarray]]:
    """Train as the JAX example does; returns the state and each window's
    losses (one per update, the same on every rank)."""
    p = argparse.ArgumentParser(prog="mgn_tpu_torch.examples.multihost_cylinder",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ds_path")
    p.add_argument("graph_axis", nargs="?", type=int, default=0)
    p.add_argument("--dist-backend", default="nccl", choices=list(BACKENDS),
                   help="gloo on the CPU and for ranks sharing one card")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    _process_group(a.dist_backend)
    log = MetricsLogger()
    data_ax, graph_ax = mesh_shape_for(dist.get_world_size(), a.graph_axis)
    mesh = make_device_mesh(data_ax, graph_ax, a.dist_backend, a.device)
    log.log("mesh", data=data_ax, graph=graph_ax)

    ds = load_dataset(a.ds_path, is_training=True)
    spec = FieldSpec.from_meta(ds.meta)
    quantities, e_norm, n_norms, o_norms = N.normalizers_from_meta(ds.meta)
    cfg = MGNConfig(node_input_dim=quantities, edge_input_dim=3, output_dim=spec.output_dim,
                    latent_size=LATENT, hidden_layers=HIDDEN, message_passing_steps=MPS)
    params = initial_params(cfg, mesh.device)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    state = TrainState(params=params, optimizer=torch.optim.Adam(leaves, lr=LR),
                       norm=NormState(edge=e_norm, node=n_norms, output=o_norms).to(mesh.device))
    step = make_spmd_derivative_step(mesh, cfg, spec, (NOISE,), norm_steps=NORM_STEPS)

    # each trajectory group partitioned once, this rank's part kept on its device
    shards: Dict[Tuple[int, ...], Any] = {}
    rng = np.random.default_rng(0)
    history = []
    for it in range(FRAMES // WINDOW):
        idxs = tuple((it * data_ax + b) % ds.num_trajectories for b in range(data_ax))
        if idxs not in shards:
            pts, fls, tms = [], [], []
            for i in idxs:
                tr = ds.trajectory(i)
                s, r = cells_to_edges(tr.cells)
                pts.append(add_halo_plan(partition_template(tr.mesh_pos, tr.node_type, s, r,
                                                            graph_ax)))
                fls.append({f: tr.fields[f] for f in spec.fields})
                tms.append(tr.times)
            batch = batch_from_partitioned(pts, fls, tms)
            shards[idxs] = (batch.shard(mesh.data_rank, mesh.graph_rank, "halo", mesh.device),
                            [len(t) - 1 for t in tms])
        shard, n_frames = shards[idxs]
        k = min(WINDOW, min(n_frames))
        perms = np.stack([rng.permutation(nf)[:k] for nf in n_frames], 1)
        state, losses = step(state, shard, perms, it)
        history.append(losses.numpy())
        log.log("train", step=int(state.step), loss=float(losses.mean()))
    return state, history


if __name__ == "__main__":
    main()
