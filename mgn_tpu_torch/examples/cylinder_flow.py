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
evaluations export ``trajectories.h5`` and so need ``h5py``.  The options
after the paths (``--steps``, ``--tstop``, ``--mps``, ...) override the
workflow's size and length; their defaults are the JAX example's.
"""

from __future__ import annotations

import argparse

import torch

from mgn_tpu_torch import (DerivativeTraining, MetricsLogger, SolverTraining, eval_network,
                           train_network)

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
LR = 1e-4
MSE_STEPS = (50, 100, 300, 599)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mgn_tpu_torch.examples.cylinder_flow",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["train-derivative", "train-solver", "eval-euler",
                                    "eval-tsit5"])
    p.add_argument("paths", nargs="+", help="ds_path cp_path (train), and out_path (eval)")
    p.add_argument("--steps", type=int, default=None,
                   help="optimizer steps (default 10,000 derivative, 1,000 solver)")
    p.add_argument("--checkpoint", type=int, default=None,
                   help="steps between checkpoints (default 1,000 derivative, 100 solver)")
    p.add_argument("--tstop", type=float, default=5.99,
                   help="the solver window's end (0:0.01:tstop)")
    p.add_argument("--mse-steps", type=int, nargs="+", default=list(MSE_STEPS))
    p.add_argument("--mps", type=int, default=HYPERS["mps"])
    p.add_argument("--layer-size", type=int, default=HYPERS["layer_size"])
    p.add_argument("--hidden-layers", type=int, default=HYPERS["hidden_layers"])
    p.add_argument("--norm-steps", type=int, default=HYPERS["norm_steps"])
    p.add_argument("--num-rollouts", type=int, default=HYPERS["num_rollouts"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> None:
    a = _parser().parse_args(argv)
    hypers = dict(HYPERS, mps=a.mps, layer_size=a.layer_size, hidden_layers=a.hidden_layers,
                  norm_steps=a.norm_steps, num_rollouts=a.num_rollouts)
    ds_path, cp_path = a.paths[0], a.paths[1]
    log = MetricsLogger()
    adam = lambda ps: torch.optim.Adam(ps, lr=LR)  # noqa: E731
    if a.mode == "train-derivative":
        train_network(NOISE, adam, ds_path, cp_path, training_strategy=DerivativeTraining(),
                      steps=a.steps or 10_000, checkpoint=a.checkpoint or 1_000, metrics=log,
                      device=a.device, **hypers)
    elif a.mode == "train-solver":
        # fixed-step Euler over 0:0.01:tstop, as in the reference workflow
        train_network(NOISE, adam, ds_path, cp_path,
                      training_strategy=SolverTraining(tstart=0.0, dt=0.01, tstop=a.tstop,
                                                       solver="euler"),
                      steps=a.steps or 1_000, checkpoint=a.checkpoint or 100, metrics=log,
                      device=a.device, **hypers)
    else:
        solver = "euler" if a.mode == "eval-euler" else "tsit5_adaptive"
        eval_network(ds_path, cp_path, a.paths[2], solver=solver,
                     mse_steps=tuple(a.mse_steps), metrics=log, device=a.device, **hypers)


if __name__ == "__main__":
    main()
