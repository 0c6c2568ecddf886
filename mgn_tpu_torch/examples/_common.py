"""What the example drivers share: their options and the train / eval calls."""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from mgn_tpu_torch import MetricsLogger, eval_network, train_network
from mgn_tpu_torch.parallel.mesh import is_writer

LR = 1e-4  # Adam's learning rate in every example


def parser(prog: str, doc: str, modes: Sequence[str], hypers: Dict[str, Any],
           mse_steps: Sequence[int], steps: Optional[int],
           checkpoint: Optional[int]) -> argparse.ArgumentParser:
    """``mode paths...`` and the options that override an example's size and
    length; their defaults are the JAX example's (None where the example's
    mode picks them)."""
    p = argparse.ArgumentParser(prog=prog, description=doc,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=list(modes))
    p.add_argument("paths", nargs="+", help="ds_path cp_path (train), and out_path (eval)")
    p.add_argument("--steps", type=int, default=steps, help="optimizer steps")
    p.add_argument("--checkpoint", type=int, default=checkpoint,
                   help="steps between checkpoints")
    p.add_argument("--mse-steps", type=int, nargs="+", default=list(mse_steps))
    p.add_argument("--mps", type=int, default=hypers["mps"])
    p.add_argument("--layer-size", type=int, default=hypers["layer_size"])
    p.add_argument("--hidden-layers", type=int, default=hypers["hidden_layers"])
    p.add_argument("--norm-steps", type=int, default=hypers["norm_steps"])
    p.add_argument("--num-rollouts", type=int, default=hypers.get("num_rollouts", 10))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def sized(hypers: Dict[str, Any], a: argparse.Namespace) -> Dict[str, Any]:
    """``hypers`` with the options' widths, depth and counts."""
    return dict(hypers, mps=a.mps, layer_size=a.layer_size, hidden_layers=a.hidden_layers,
                norm_steps=a.norm_steps, num_rollouts=a.num_rollouts)


def train(a: argparse.Namespace, hypers: Dict[str, Any],
          noise: Union[float, Tuple[float, ...]], **kwargs: Any):
    """``train_network`` on ``paths[0]`` into ``paths[1]`` with Adam
    (:data:`LR`)."""
    return train_network(noise, lambda ps: torch.optim.Adam(ps, lr=LR), a.paths[0], a.paths[1],
                         steps=a.steps, checkpoint=a.checkpoint, metrics=MetricsLogger(),
                         device=a.device, **sized(hypers, a), **kwargs)


def evaluate(a: argparse.Namespace, hypers: Dict[str, Any], out_path: str, **kwargs: Any):
    """``eval_network`` of the checkpoint ``paths[1]`` on ``paths[0]``'s
    test split, exported under ``out_path``; prints each trajectory's final
    RMSE."""
    reports = eval_network(a.paths[0], a.paths[1], out_path, mse_steps=tuple(a.mse_steps),
                           metrics=MetricsLogger(), device=a.device, **sized(hypers, a),
                           **kwargs)
    if is_writer():  # rank 0 of a graph-parallel run
        for i, r in enumerate(reports):
            print(f"trajectory {i}: final_rmse={r['final_rmse']:.4e}")
    return reports
