"""DeformingPlate example: the twin of
``examples/deforming_plate/deforming_plate.py`` — a 3-D quasi-static solid
on a structured grid mesh, with world positions (a derivative head) and
stress (an ``output_mode: absolute`` value head) as targets.

DeepMind-default hyperparameters (15 message-passing steps, latent 128, 2
hidden layers, Adam lr 1e-4, noise 0.003, types_updated [0, 6]: every node
but the held handle, types_noisy [0]):

    python -m mgn_tpu_torch.examples.deforming_plate train <ds_path> <cp_path>
    python -m mgn_tpu_torch.examples.deforming_plate eval  <ds_path> <cp_path> <out_path>

``python -m mgn_tpu_torch synth <ds_path> --family plate`` writes a
synthetic dataset.  The evaluation is Euler and exports ``trajectories.h5``
(``.npz`` without ``h5py``).  The options after the paths override the size
and length; their defaults are the JAX example's.
"""

from __future__ import annotations

from mgn_tpu_torch.examples import _common

HYPERS = dict(mps=15, layer_size=128, hidden_layers=2, norm_steps=1000,
              types_updated=(0, 6), types_noisy=(0,), num_rollouts=10)
NOISE = 0.003
MSE_STEPS = (10, 50)


def main(argv=None) -> None:
    a = _common.parser("mgn_tpu_torch.examples.deforming_plate", __doc__, ("train", "eval"),
                       HYPERS, MSE_STEPS, steps=10_000, checkpoint=1_000).parse_args(argv)
    if a.mode == "train":
        _common.train(a, HYPERS, NOISE)
    else:
        _common.evaluate(a, HYPERS, a.paths[2], solver="euler")


if __name__ == "__main__":
    main()
