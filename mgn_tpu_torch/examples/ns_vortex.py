"""Navier-Stokes vortex shedding: the twin of ``examples/ns_vortex/ns_vortex.py``.
The built-in incompressible-NS projection solver (``mgn_tpu_torch.data.ns``)
writes the trajectories offline on the CPU, and the standard entry points
train (in bf16) and evaluate on them:

    python -m mgn_tpu_torch.examples.ns_vortex synth <ds_path>   # ~30 min of CPU, 38 trajectories
    python -m mgn_tpu_torch.examples.ns_vortex train <ds_path> <cp_path>
    python -m mgn_tpu_torch.examples.ns_vortex eval  <ds_path> <cp_path> <out_path>

DeepMind-default hyperparameters (15 message-passing steps, latent 128, 2
hidden layers, Adam lr 1e-4, noise 0.02, types_updated [0, 5], types_noisy
[0]) with ``compute_dtype="bfloat16"``.  ``synth`` writes TFRecord at the JAX
example's sizes (1,900 nodes, 600 frames, 32 + 2 + 4 trajectories on a
256 x 128 grid; ``python -m mgn_tpu_torch synth --family ns`` takes smaller
ones).  The evaluation is Euler and exports ``trajectories.h5`` (``.npz``
without ``h5py``).
"""

from __future__ import annotations

from mgn_tpu_torch.data.ns import write_ns_tfrecord_dataset
from mgn_tpu_torch.examples import _common

HYPERS = dict(mps=15, layer_size=128, hidden_layers=2, norm_steps=1000,
              types_updated=(0, 5), types_noisy=(0,), num_rollouts=4,
              compute_dtype="bfloat16")
NOISE = 0.02
MSE_STEPS = (50, 100, 300, 599)
SYNTH = dict(num_nodes=1900, tl=600, n_train=32, n_valid=2, n_test=4)


def main(argv=None) -> None:
    a = _common.parser("mgn_tpu_torch.examples.ns_vortex", __doc__, ("synth", "train", "eval"),
                       HYPERS, MSE_STEPS, steps=200_000, checkpoint=10_000).parse_args(argv)
    if a.mode == "synth":
        write_ns_tfrecord_dataset(a.paths[0], **SYNTH)
    elif a.mode == "train":
        _common.train(a, HYPERS, NOISE)
    else:
        _common.evaluate(a, HYPERS, a.paths[2], solver="euler")


if __name__ == "__main__":
    main()
