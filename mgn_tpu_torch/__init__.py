"""mgn_tpu_torch — the PyTorch/CUDA port of mgn_tpu for NVIDIA Hopper.

A second package beside the JAX one (``mgn_tpu/``, the frozen reference).  It
imports ``torch``, numpy and scipy only — never JAX or anything of
``mgn_tpu`` — and mirrors ``mgn_tpu``'s layout (``core/``, ``models/``,
``ops/``, ``rollout/``, ``train/``, ``checkpoint/``, ``data/``, ``api.py``,
``config.py``).  The Pallas TPU kernels on its paths are hand-written CUDA
kernels for ``sm_90a`` under ``ops/csrc/``, built at first use.

This slice serves: :func:`simulate` rolls a trained MeshGraphNet out from one
frame on the GPU.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from mgn_tpu_torch.api import build_model_config, simulate
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax, save_checkpoint_from_jax
from mgn_tpu_torch.models.mgn import MGNConfig, apply_mgn, init_mgn

__all__ = [
    "simulate",
    "build_model_config",
    "Args",
    "MGNConfig",
    "init_mgn",
    "apply_mgn",
    "params_from_jax",
    "norm_from_jax",
    "save_checkpoint_from_jax",
]
