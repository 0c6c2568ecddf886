"""Airfoil example: the twin of ``examples/airfoil/airfoil.py`` — compressible
flow with two targets, velocity (2) and density (1), through the generic
derivative-training path; the output head is sized from meta.json.

DeepMind-default hyperparameters (15 message-passing steps, latent 128, 2
hidden layers, Adam lr 1e-4, per-field noise 10.0 on velocity and 0.01 on
density, types_updated [0, 5], types_noisy [0]):

    python -m mgn_tpu_torch.examples.airfoil train <ds_path> <cp_path>
    python -m mgn_tpu_torch.examples.airfoil eval  <ds_path> <cp_path> <out_path>

``python -m mgn_tpu_torch synth <ds_path> --family airfoil`` writes a
synthetic dataset.  The evaluation is Euler and exports ``trajectories.h5``
(``.npz`` without ``h5py``).  The options after the paths override the size
and length; their defaults are the JAX example's.
"""

from __future__ import annotations

from mgn_tpu_torch.examples import _common

HYPERS = dict(mps=15, layer_size=128, hidden_layers=2, norm_steps=1000,
              types_updated=(0, 5), types_noisy=(0,), num_rollouts=10)
NOISE = (10.0, 0.01)  # velocity, density
MSE_STEPS = (50, 100, 300)


def main(argv=None) -> None:
    a = _common.parser("mgn_tpu_torch.examples.airfoil", __doc__, ("train", "eval"), HYPERS,
                       MSE_STEPS, steps=10_000, checkpoint=1_000).parse_args(argv)
    if a.mode == "train":
        _common.train(a, HYPERS, NOISE)
    else:
        _common.evaluate(a, HYPERS, a.paths[2], solver="euler")


if __name__ == "__main__":
    main()
