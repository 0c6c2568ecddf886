"""Derivative (1-step finite-difference) training — the default strategy: the
port's ``make_derivative_trainer`` of ``mgn_tpu/train/derivative.py``.

Per sampled frame t:

    target = o_norm((u[t+1] - (u[t] + noise)) / dt)    (or o_norm(u[t+1]) for
                                                        an ``absolute`` head)
    loss   = masked MSE(model(graph(u[t] + noise)), target)

with Gaussian noise only on node types in ``types_noisy``, online-normalizer
accumulation before the loss, and optimizer updates gated off during the
first ``norm_steps`` steps.  The JAX package scans the window in one jitted
``lax.scan``; here the window is a Python loop over the permutation, and the
processor's forward and backward run through the CUDA kernels of
:mod:`mgn_tpu_torch.ops.fused`.

Warm-up: JAX computes the gradient and discards it with ``jnp.where``; the
optimizer state stays put.  Here a warm-up step runs the forward under
``torch.no_grad()`` and takes no optimizer step, which leaves parameters,
optimizer state (Adam's moments and its bias-correction count) and loss the
same.  The batched and union trainers are not ported yet (ROADMAP A2.5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import GraphTemplate
from mgn_tpu_torch.models.mgn import MGNConfig, apply_mgn
from mgn_tpu_torch.train.common import (FieldSpec, NormState, TrainState,
                                        assemble_graph, masked_mse, type_mask)

__all__ = ["DerivativeTrainerConfig", "make_derivative_trainer", "frame_inputs"]


@dataclasses.dataclass(frozen=True)
class DerivativeTrainerConfig:
    model: MGNConfig
    spec: FieldSpec
    noise_stddevs: Tuple[float, ...]  # one per target field (or broadcast len 1)
    types_updated: Tuple[int, ...] = (0, 5)
    types_noisy: Tuple[int, ...] = (0,)
    norm_steps: int = 1000

    def sigma(self, i: int) -> float:
        return self.noise_stddevs[i if len(self.noise_stddevs) > 1 else 0]


def frame_inputs(cfg: DerivativeTrainerConfig, fields: Dict[str, torch.Tensor],
                 times: torch.Tensor, t: int, noisy_mask: torch.Tensor,
                 gen: torch.Generator) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Frame ``t``'s model inputs and raw targets: each target field gets
    ``sigma * N(0, 1)`` noise (from ``gen``) on the ``noisy_mask`` nodes
    only; its target is ``(u[t+1] - noisy u[t]) / dt``, or ``u[t+1]`` for an
    ``absolute`` head."""
    spec = cfg.spec
    dt = times[t + 1] - times[t]
    u: Dict[str, torch.Tensor] = {}
    targets_raw: Dict[str, torch.Tensor] = {}
    for f in spec.fields:
        frame = fields[f][t]
        if f in spec.target_fields:
            ti = spec.target_fields.index(f)
            nxt = fields[f][t + 1]
            noise = cfg.sigma(ti) * torch.randn(frame.shape, generator=gen, device=frame.device)
            frame = frame + noise * noisy_mask[:, None]
            targets_raw[f] = nxt if spec.mode(ti) == "absolute" else (nxt - frame) / dt
        u[f] = frame
    return u, targets_raw


def make_derivative_trainer(cfg: DerivativeTrainerConfig) -> Callable:
    """Build ``train_window(state, template, fields, times, perm, generator)``.

    - ``fields``: dict of dynamic node fields, each (T, N_pad, dim), padded,
      on the training device;
    - ``perm``: sequence of frame indices in [0, T-1) — shuffled or ordered;
    - ``generator``: the ``torch.Generator`` (on the training device) the
      noise is drawn from;
    - returns ``(state, losses (len(perm),) f32 on the host)``; ``state`` is
      updated in place (parameters through the optimizer) and returned.
    """
    spec = cfg.spec

    def one_step(state: TrainState, template: GraphTemplate, fields, times, t: int,
                 gen: torch.Generator) -> torch.Tensor:
        node_mask = template.node_mask
        update_mask = type_mask(template.node_type, cfg.types_updated) & node_mask
        noisy_mask = type_mask(template.node_type, cfg.types_noisy) & node_mask
        with torch.no_grad():
            u, targets_raw = frame_inputs(cfg, fields, times, t, noisy_mask, gen)
            # normalizer accumulation (the train-mode side effect of the
            # reference's normalizer calls), before the loss
            norm = state.norm
            node = N.accumulate_tree(norm.node, {f: u[f] for f in spec.fields}, node_mask)
            out = N.accumulate_tree(norm.output, targets_raw, node_mask)
            edge = N.accumulate(norm.edge, template.mesh_edge_features, template.edge_mask)
            state.norm = NormState(edge=edge, node=node, output=out)
            target = torch.cat([state.norm.output[f](targets_raw[f])
                                for f in spec.target_fields], dim=-1)
            graph = assemble_graph(state.norm, template, u, spec)

        def loss_fn():
            pred = apply_mgn(state.params, graph, cfg.model, template.row_offsets,
                             template.sender_perm, template.sender_offsets)
            return masked_mse(pred, target, update_mask)

        if state.step >= cfg.norm_steps:
            state.optimizer.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            state.optimizer.step()
        else:
            with torch.no_grad():
                loss = loss_fn()
        state.step += 1
        return loss.detach()

    def train_window(state: TrainState, template: GraphTemplate,
                     fields: Dict[str, torch.Tensor], times: torch.Tensor, perm,
                     generator: torch.Generator):
        losses = [one_step(state, template, fields, times, int(t), generator) for t in perm]
        return state, torch.stack(losses).float().cpu()

    return train_window
