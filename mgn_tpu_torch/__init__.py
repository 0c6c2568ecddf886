"""mgn_tpu_torch — the PyTorch/CUDA port of mgn_tpu for NVIDIA Hopper.

A second package beside the JAX one (``mgn_tpu/``, the frozen reference).  It
imports ``torch``, numpy and scipy only — never JAX or anything of
``mgn_tpu`` — and mirrors ``mgn_tpu``'s layout (``core/``, ``models/``,
``ops/``, ``rollout/``, ``train/``, ``checkpoint/``, ``data/``, ``api.py``,
``config.py``).  The Pallas TPU kernels on its paths are hand-written CUDA
kernels for ``sm_90a`` under ``ops/csrc/``, built at first use.

It trains and serves: :func:`train_network` trains a MeshGraphNet with
derivative training, forward and backward through the processor kernels,
and on a cloth dataset the cloth / world-edge family (FlagSimple,
:func:`train_network_cloth`); :func:`simulate` rolls a trained one out from
one frame; :func:`cloth_simulator` serves the cloth family.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from mgn_tpu_torch.api import build_model_config, init_state, simulate, train_network
from mgn_tpu_torch.api_cloth import init_cloth_state, is_cloth_meta, train_network_cloth
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import (norm_from_jax, params_from_jax, save_checkpoint_from_jax,
                                   save_train_state_from_jax)
from mgn_tpu_torch.models.mgn import MGNConfig, apply_mgn, init_mgn
from mgn_tpu_torch.models.mgn_multi import MultiMGNConfig, apply_mgn_multi, init_mgn_multi
from mgn_tpu_torch.serve import cloth_simulator
from mgn_tpu_torch.train.cloth import (ClothConfig, cloth_model_config, make_cloth_norm_state,
                                       make_cloth_rollout, make_cloth_trainer)
from mgn_tpu_torch.train.common import TrainState
from mgn_tpu_torch.train.strategies import DerivativeTraining
from mgn_tpu_torch.utils.metrics import MetricsLogger

__all__ = [
    "train_network",
    "simulate",
    "init_state",
    "TrainState",
    "DerivativeTraining",
    "MetricsLogger",
    "save_train_state_from_jax",
    "build_model_config",
    "Args",
    "MGNConfig",
    "init_mgn",
    "apply_mgn",
    "params_from_jax",
    "norm_from_jax",
    "save_checkpoint_from_jax",
    "cloth_simulator",
    "ClothConfig",
    "cloth_model_config",
    "make_cloth_norm_state",
    "make_cloth_rollout",
    "make_cloth_trainer",
    "train_network_cloth",
    "init_cloth_state",
    "is_cloth_meta",
    "MultiMGNConfig",
    "init_mgn_multi",
    "apply_mgn_multi",
]
