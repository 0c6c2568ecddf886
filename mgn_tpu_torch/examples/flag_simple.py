"""FlagSimple example: the twin of ``examples/flag_simple/flag_simple.py`` —
cloth with 3-D world dynamics and dynamic world edges, driven by the same
entry points as every other dataset (``train_network`` and
``eval_network`` dispatch on meta.json's ``world_edges`` key to
``mgn_tpu_torch.api_cloth``):

    python -m mgn_tpu_torch.examples.flag_simple train <ds_path> <cp_path>
    python -m mgn_tpu_torch.examples.flag_simple eval  <ds_path> <cp_path> [<out_path>]

DeepMind-default hyperparameters (15 message-passing steps, latent 128, 2
hidden layers, Adam lr 1e-4, noise 0.003 on the world positions,
types_updated [0]: the cloth, type 3 is the pinned handle).  The evaluation
is the semi-implicit rollout, exported under ``<out_path>`` (default
``<cp_path>_out``) as ``trajectories.h5`` (``.npz`` without ``h5py``).
``python -m mgn_tpu_torch synth <ds_path> --family flag`` writes a synthetic
dataset.  ``--graph-parallel N`` partitions each mesh over N ranks, one
process each, launched by torchrun (``--dist-backend gloo`` where the ranks
share one card, or on the CPU):

    torchrun --nproc-per-node N -m mgn_tpu_torch.examples.flag_simple train \
        <ds_path> <cp_path> --graph-parallel N [--dist-backend nccl|gloo]
"""

from __future__ import annotations

from mgn_tpu_torch.examples import _common
from mgn_tpu_torch.parallel.mesh import BACKENDS, initialize_multihost

HYPERS = dict(mps=15, layer_size=128, hidden_layers=2, types_updated=(0,), types_noisy=(0,),
              norm_steps=1000)
NOISE = 0.003
MSE_STEPS = (10, 30, 100)


def main(argv=None) -> None:
    p = _common.parser("mgn_tpu_torch.examples.flag_simple", __doc__, ("train", "eval"),
                       HYPERS, MSE_STEPS, steps=100_000, checkpoint=5_000)
    p.add_argument("--graph-parallel", type=int, default=1,
                   help="partition each mesh over this many ranks (run under torchrun)")
    p.add_argument("--dist-backend", default="nccl", choices=list(BACKENDS),
                   help="the process group's backend under --graph-parallel (gloo on the CPU "
                        "and for ranks sharing one card)")
    a = p.parse_args(argv)
    if a.graph_parallel > 1:
        initialize_multihost(a.dist_backend)  # from torchrun's environment
    if a.mode == "train":
        _common.train(a, HYPERS, NOISE, graph_parallel=a.graph_parallel)
    else:
        _common.evaluate(a, HYPERS, a.paths[2] if len(a.paths) > 2 else a.paths[1] + "_out",
                         graph_parallel=a.graph_parallel)


if __name__ == "__main__":
    main()
