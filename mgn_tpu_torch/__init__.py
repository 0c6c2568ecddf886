"""mgn_tpu_torch — the PyTorch/CUDA port of mgn_tpu for NVIDIA Hopper.

A second package beside the JAX one (``mgn_tpu/``, the frozen reference).  It
imports ``torch``, numpy and scipy only — never JAX or anything of
``mgn_tpu`` — and mirrors ``mgn_tpu``'s layout (``core/``, ``models/``,
``ops/``, ``rollout/``, ``train/``, ``checkpoint/``, ``data/``, ``api.py``,
``config.py``).  The Pallas TPU kernels on its paths are hand-written CUDA
kernels for ``sm_90a`` under ``ops/csrc/``, built at first use.

It trains, evaluates and serves: :func:`train_network` trains a
MeshGraphNet, forward and backward through the processor kernels, with
derivative training or through the ODE solver (:class:`SolverTraining`,
:class:`MultipleShooting`: backpropagation through the rollout), one
trajectory a step or ``batchsize`` of them as one disjoint-union graph, and
on a cloth dataset the cloth / world-edge family (FlagSimple,
:func:`train_network_cloth`), the Airfoil's multi-target head and the
DeformingPlate's 3-D grid with its ``absolute`` stress head included;
:func:`eval_network` reports a trained model's rollout error on the test
split and exports the rollouts (``trajectories.h5``, or ``.npz`` without
``h5py``);
:func:`simulate` rolls a trained one out from one frame;
:func:`cloth_simulator` serves the cloth family; :func:`export_simulator`
and :func:`export_cloth_simulator` write a self-contained artefact
(``torch.export``) that :func:`load_simulator` runs, and
:func:`export_sharded_simulator` a graph-parallel one that
:func:`load_sharded_simulator` runs on a group of ranks.  :func:`der_minmax` and
:func:`data_meanstd` compute a dataset's meta.json statistics.  Datasets
are read from TFRecord, or from HDF5/JLD2 where ``h5py`` is installed.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
``python -m mgn_tpu_torch`` is the command line (``train``, ``eval``,
``export``, ``synth``, ``convert``), where ``--device cpu`` does the same.
The synthetic families' TFRecord writers (``data/synthetic``, ``data/ns``),
dataset conversion (``data/convert``) and the native graph builder
(``ops/native``) are the JAX package's host code, copied.  The names
below import their modules at first use.
"""

import importlib
from typing import Any, List

# public name -> the module that defines it; each is imported at its first
# use, so that a module that needs none of them (a loaded serving artefact:
# mgn_tpu_torch.serve.load_simulator, mgn_tpu_torch.ops.library) imports
# nothing of api, models or data
_EXPORTS = {
    **dict.fromkeys(("build_model_config", "eval_network", "init_state", "simulate",
                     "train_network"), "mgn_tpu_torch.api"),
    **dict.fromkeys(("eval_network_cloth", "init_cloth_state", "is_cloth_meta",
                     "train_network_cloth"), "mgn_tpu_torch.api_cloth"),
    "Args": "mgn_tpu_torch.config",
    **dict.fromkeys(("norm_from_jax", "params_from_jax", "save_checkpoint_from_jax",
                     "save_train_state_from_jax"), "mgn_tpu_torch.convert"),
    **dict.fromkeys(("MGNConfig", "apply_mgn", "init_mgn"), "mgn_tpu_torch.models.mgn"),
    **dict.fromkeys(("MultiMGNConfig", "apply_mgn_multi", "init_mgn_multi"),
                    "mgn_tpu_torch.models.mgn_multi"),
    **dict.fromkeys(("cloth_simulator", "export_simulator", "export_cloth_simulator",
                     "export_sharded_simulator", "load_simulator", "load_sharded_simulator"),
                    "mgn_tpu_torch.serve"),
    **dict.fromkeys(("ClothConfig", "cloth_model_config", "make_cloth_norm_state",
                     "make_cloth_rollout", "make_cloth_trainer"), "mgn_tpu_torch.train.cloth"),
    "TrainState": "mgn_tpu_torch.train.common",
    **dict.fromkeys(("DerivativeTraining", "MultipleShooting", "SolverTraining"),
                    "mgn_tpu_torch.train.strategies"),
    "MetricsLogger": "mgn_tpu_torch.utils.metrics",
    **dict.fromkeys(("data_meanstd", "der_minmax"), "mgn_tpu_torch.utils.stats"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str) -> Any:
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'mgn_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__() -> List[str]:
    return sorted(set(globals()) | set(_EXPORTS))
