"""CylinderFlow example: training and evaluation driver of the port, the
twin of ``examples/cylinder_flow/cylinder_flow.py``.

DeepMind-default hyperparameters (15 message-passing steps, latent 128, 2
hidden layers, Adam lr 1e-4, noise 0.02, types_updated [0, 5], types_noisy
[0]) and the same four workflows:

    python -m mgn_tpu_torch.examples.cylinder_flow train-derivative <ds_path> <cp_path>
    python -m mgn_tpu_torch.examples.cylinder_flow train-solver     <ds_path> <cp_path>
    python -m mgn_tpu_torch.examples.cylinder_flow eval-euler       <ds_path> <cp_path> <out_path>
    python -m mgn_tpu_torch.examples.cylinder_flow eval-tsit5       <ds_path> <cp_path> <out_path>

``<ds_path>`` holds meta.json and train/valid/test files (TFRecord, or HDF5
where ``h5py`` is installed); ``python -m mgn_tpu_torch synth <ds_path>``
writes a synthetic one (``--tl 600`` for the full solver window).  The
evaluations export ``trajectories.h5`` (``.npz`` where ``h5py`` is not
installed).  The options
after the paths (``--steps``, ``--tstop``, ``--mps``, ...) override the
workflow's size and length; their defaults are the JAX example's
(``--steps`` 10,000 and ``--checkpoint`` 1,000 for derivative training,
1,000 and 100 for solver training).
"""

from __future__ import annotations

from mgn_tpu_torch import DerivativeTraining, MetricsLogger, SolverTraining, eval_network
from mgn_tpu_torch.examples import _common

HYPERS = dict(
    mps=15,
    layer_size=128,
    hidden_layers=2,
    norm_steps=1000,
    types_updated=(0, 5),
    types_noisy=(0,),
    num_rollouts=10,
)

NOISE = 0.02
MSE_STEPS = (50, 100, 300, 599)
MODES = ("train-derivative", "train-solver", "eval-euler", "eval-tsit5")


def main(argv=None) -> None:
    p = _common.parser("mgn_tpu_torch.examples.cylinder_flow", __doc__, MODES, HYPERS,
                       MSE_STEPS, steps=None, checkpoint=None)
    p.add_argument("--tstop", type=float, default=5.99,
                   help="the solver window's end (0:0.01:tstop)")
    a = p.parse_args(argv)
    if a.mode == "train-derivative":
        a.steps, a.checkpoint = a.steps or 10_000, a.checkpoint or 1_000
        _common.train(a, HYPERS, NOISE, training_strategy=DerivativeTraining())
    elif a.mode == "train-solver":
        # fixed-step Euler over 0:0.01:tstop, as in the reference workflow
        a.steps, a.checkpoint = a.steps or 1_000, a.checkpoint or 100
        _common.train(a, HYPERS, NOISE,
                      training_strategy=SolverTraining(tstart=0.0, dt=0.01, tstop=a.tstop,
                                                       solver="euler"))
    else:
        solver = "euler" if a.mode == "eval-euler" else "tsit5_adaptive"
        eval_network(a.paths[0], a.paths[1], a.paths[2], solver=solver,
                     mse_steps=tuple(a.mse_steps), metrics=MetricsLogger(), device=a.device,
                     **_common.sized(HYPERS, a))


if __name__ == "__main__":
    main()
