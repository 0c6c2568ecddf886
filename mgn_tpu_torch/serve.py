"""Serving the cloth family: the port's counterpart of
``mgn_tpu/serve.py:export_cloth_simulator``.

:func:`cloth_simulator` builds, once, the callable that the JAX package
bakes into its artifact: ``(times (T,), wp_drive (T, N, 3)) -> pred (T, N,
3)``, the semi-implicit rollout of :func:`mgn_tpu_torch.train.cloth.make_cloth_rollout`
with the world-edge radius query at every step, in the caller's node order.
It runs on the GPU through the processor kernels (K1, K2, K3 with its
``node_extra`` form); ``device="cpu"`` runs the plain PyTorch path.

Serialising the simulator (``torch.export``, ROADMAP A5) is not done: the
kernels launch through ``ctypes``, which ``torch.export`` cannot trace.
The JAX package's ``export_simulator`` / ``load_simulator`` for the
single-edge-set family wait for A5 too.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device, tree_to
from mgn_tpu_torch.core.graph import build_template
from mgn_tpu_torch.train.cloth import ClothConfig, make_cloth_rollout
from mgn_tpu_torch.train.common import NormState

__all__ = ["cloth_simulator"]


def cloth_simulator(params: Dict[str, Any], norm: NormState, mesh_pos: np.ndarray,
                    node_type: np.ndarray, cells: np.ndarray, cfg: ClothConfig,
                    num_steps: Optional[int] = None, type_min: int = 0, type_max: int = 6,
                    device: Optional[Union[str, torch.device]] = None) -> Callable:
    """The cloth simulator for one mesh: ``simulate(times (T,), wp_drive
    (T, N, 3)) -> pred (T, N, 3)`` (numpy, f32).

    Rows of ``wp_drive`` at handle nodes (types outside
    ``cfg.types_updated``) are the kinematic drive read at every step; the
    other rows are read only at the first two frames.  ``type_min`` /
    ``type_max`` must match the meta's ``node_type`` range the model was
    configured from.  ``num_steps``, where given, fixes ``T`` as the JAX
    artifact does.  The graph template, the weights and the normalizers
    move to ``device`` once, here (``None``: the GPU, raising without one);
    each call runs under ``torch.no_grad()``.
    """
    dev = resolve_device(device)
    node_type = np.asarray(node_type, np.int32).reshape(-1)
    n_raw = node_type.shape[0]
    template = build_template(np.asarray(mesh_pos, np.float32), node_type,
                              cells=np.asarray(cells, np.int32), type_min=type_min,
                              type_max=type_max).to(dev)
    params, norm = tree_to(params, dev), norm.to(dev)
    n_pad, wd = template.num_nodes, cfg.world_dim
    rollout = make_cloth_rollout(cfg)

    def simulate(times, wp_drive) -> np.ndarray:
        times_t = torch.as_tensor(times, dtype=torch.float32).to(dev)
        wp = torch.as_tensor(wp_drive, dtype=torch.float32).to(dev)
        steps = times_t.shape[0]
        if wp.shape != (steps, n_raw, wd) or (num_steps is not None and steps != num_steps):
            raise ValueError(f"expected times ({num_steps or 'T'},) and wp_drive (T, {n_raw}, "
                             f"{wd}), got {tuple(times_t.shape)} and {tuple(wp.shape)}")
        padded = wp.new_zeros((steps, n_pad, wd))
        padded[:, :n_raw] = wp
        with torch.no_grad():
            pred = rollout(params, norm, template, padded, times_t)
        return pred[:, :n_raw].cpu().numpy()

    return simulate
