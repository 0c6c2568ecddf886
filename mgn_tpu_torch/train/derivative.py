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
same.

``batchsize > 1`` trains B trajectories a step.  The union trainer
(:func:`make_union_derivative_trainer`, the route ``train_network`` takes)
runs one forward and backward over their disjoint union
(:mod:`mgn_tpu_torch.data.union`), one frame of each subgraph a step; the
batched trainer (:func:`make_batched_derivative_trainer`, which the JAX
package exports beside it) runs the B graphs' forwards one after another and
takes one update on the loss over all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import GraphTemplate
from mgn_tpu_torch.models.mgn import MGNConfig, apply_mgn
from mgn_tpu_torch.train.common import (FieldSpec, NormState, TrainState,
                                        assemble_graph, masked_mse, type_mask)

__all__ = ["DerivativeTrainerConfig", "make_derivative_trainer",
           "make_batched_derivative_trainer", "make_union_derivative_trainer", "frame_inputs"]


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
                 times: torch.Tensor, t: Union[int, torch.Tensor], noisy_mask: torch.Tensor,
                 gen: torch.Generator) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Frame ``t``'s model inputs and raw targets: each target field gets
    ``sigma * N(0, 1)`` noise (from ``gen``) on the ``noisy_mask`` nodes
    only; its target is ``(u[t+1] - noisy u[t]) / dt``, or ``u[t+1]`` for an
    ``absolute`` head.  ``t`` is one frame index, or an ``(N,)`` tensor of
    frame indices, one a node, each node's ``dt`` its own (a union graph,
    one frame of each subgraph)."""
    spec = cfg.spec
    if isinstance(t, torch.Tensor):
        rows = torch.arange(t.shape[0], device=t.device)

        def frame_at(arr: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
            return arr[k, rows]

        dt = (times[t + 1] - times[t])[:, None]
    else:
        def frame_at(arr: torch.Tensor, k: int) -> torch.Tensor:
            return arr[k]

        dt = times[t + 1] - times[t]
    u: Dict[str, torch.Tensor] = {}
    targets_raw: Dict[str, torch.Tensor] = {}
    for f in spec.fields:
        frame = frame_at(fields[f], t)
        if f in spec.target_fields:
            ti = spec.target_fields.index(f)
            nxt = frame_at(fields[f], t + 1)
            noise = cfg.sigma(ti) * torch.randn(frame.shape, generator=gen, device=frame.device)
            frame = frame + noise * noisy_mask[:, None]
            targets_raw[f] = nxt if spec.mode(ti) == "absolute" else (nxt - frame) / dt
        u[f] = frame
    return u, targets_raw


def _accumulate(norm: NormState, spec: FieldSpec, u: Dict[str, torch.Tensor],
                targets_raw: Dict[str, torch.Tensor], node_mask: torch.Tensor,
                edge_features: torch.Tensor, edge_mask: torch.Tensor) -> NormState:
    """One normalizer accumulation over the step's rows (the train-mode side
    effect of the reference's normalizer calls), before the loss."""
    return NormState(edge=N.accumulate(norm.edge, edge_features, edge_mask),
                     node=N.accumulate_tree(norm.node, {f: u[f] for f in spec.fields},
                                            node_mask),
                     output=N.accumulate_tree(norm.output, targets_raw, node_mask))


def _gated_step(state: TrainState, norm_steps: int,
                loss_fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """Past the warm-up, ``loss_fn()``'s gradient and one optimizer step;
    during it the loss alone, under ``torch.no_grad()``.  Advances the step."""
    if state.step >= norm_steps:
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        state.optimizer.step()
    else:
        with torch.no_grad():
            loss = loss_fn()
    state.step += 1
    return loss.detach()


def _frame_step(cfg: DerivativeTrainerConfig, state: TrainState, template: GraphTemplate,
                fields: Dict[str, torch.Tensor], times: torch.Tensor,
                t: Union[int, torch.Tensor], gen: torch.Generator) -> torch.Tensor:
    """One optimizer step on frame ``t`` of one graph (``t`` per node on a
    union graph, see :func:`frame_inputs`)."""
    spec = cfg.spec
    node_mask = template.node_mask
    update_mask = type_mask(template.node_type, cfg.types_updated) & node_mask
    noisy_mask = type_mask(template.node_type, cfg.types_noisy) & node_mask
    with torch.no_grad():
        u, targets_raw = frame_inputs(cfg, fields, times, t, noisy_mask, gen)
        state.norm = _accumulate(state.norm, spec, u, targets_raw, node_mask,
                                 template.mesh_edge_features, template.edge_mask)
        target = torch.cat([state.norm.output[f](targets_raw[f])
                            for f in spec.target_fields], dim=-1)
        graph = assemble_graph(state.norm, template, u, spec)

    def loss_fn():
        pred = apply_mgn(state.params, graph, cfg.model, template.row_offsets,
                         template.sender_perm, template.sender_offsets)
        return masked_mse(pred, target, update_mask)

    return _gated_step(state, cfg.norm_steps, loss_fn)


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

    def train_window(state: TrainState, template: GraphTemplate,
                     fields: Dict[str, torch.Tensor], times: torch.Tensor, perm,
                     generator: torch.Generator):
        losses = [_frame_step(cfg, state, template, fields, times, int(t), generator)
                  for t in perm]
        return state, torch.stack(losses).float().cpu()

    return train_window


def make_union_derivative_trainer(cfg: DerivativeTrainerConfig,
                                  node_graph_ids: np.ndarray) -> Callable:
    """Disjoint-union batching: B graphs concatenated into one
    (:func:`mgn_tpu_torch.data.union.union_prepared`) train as one graph —
    one forward and backward a step over one frame of each subgraph, the
    normalizers accumulated once over all ``B * N_pad`` rows.

    ``node_graph_ids``: ``(B * N_pad,)`` node -> subgraph index
    (``UnionInfo.node_graph_ids()``).  Builds ``train_window(state,
    template, fields, times, perms, generator)`` with ``perms`` of shape
    ``(delta, B)``: step ``k`` takes frame ``perms[k, i]`` of subgraph
    ``i``.  Returns ``(state, losses (delta,) f32 on the host)``.
    """
    gids = torch.as_tensor(np.asarray(node_graph_ids), dtype=torch.long)

    def train_window(state: TrainState, template: GraphTemplate,
                     fields: Dict[str, torch.Tensor], times: torch.Tensor, perms,
                     generator: torch.Generator):
        g = gids.to(times.device)
        ts = torch.as_tensor(np.asarray(perms), dtype=torch.long, device=times.device)
        losses = [_frame_step(cfg, state, template, fields, times, row[g], generator)
                  for row in ts]
        return state, torch.stack(losses).float().cpu()

    return train_window


def make_batched_derivative_trainer(cfg: DerivativeTrainerConfig) -> Callable:
    """B trajectories a step, each graph on its own: the counterpart of the
    JAX package's vmapped trainer.  Builds ``train_window(state, templates,
    fields, times, perms, generator)``, where ``templates``, ``fields`` and
    ``times`` are sequences of the B graphs' ``GraphTemplate``, field dicts
    and ``(T,)`` times (equal buckets), and ``perms`` is ``(delta, B)``.

    A step takes frame ``perms[k, i]`` of graph ``i`` (noise drawn graph by
    graph from ``generator``), accumulates the normalizers once over the B
    graphs' rows, runs the B forwards one after another (the kernels on the
    card) and takes one update on ``sum of squared errors / max(sum of
    updated nodes, 1)`` over all of them.  Returns ``(state, losses (delta,)
    f32 on the host)``.
    """
    spec = cfg.spec

    def one_batch_step(state: TrainState, templates: Sequence[GraphTemplate], fields,
                       times, ts, gen: torch.Generator) -> torch.Tensor:
        update_masks = [type_mask(tm.node_type, cfg.types_updated) & tm.node_mask
                        for tm in templates]
        with torch.no_grad():
            frames = [frame_inputs(cfg, fl, tt, int(t),
                                   type_mask(tm.node_type, cfg.types_noisy) & tm.node_mask,
                                   gen)
                      for tm, fl, tt, t in zip(templates, fields, times, ts, strict=True)]

            def cat(get) -> torch.Tensor:
                return torch.cat([get(i) for i in range(len(templates))], dim=0)

            state.norm = _accumulate(
                state.norm, spec, {f: cat(lambda i: frames[i][0][f]) for f in spec.fields},
                {f: cat(lambda i: frames[i][1][f]) for f in spec.target_fields},
                cat(lambda i: templates[i].node_mask),
                cat(lambda i: templates[i].mesh_edge_features),
                cat(lambda i: templates[i].edge_mask))
            targets = [torch.cat([state.norm.output[f](raw[f]) for f in spec.target_fields],
                                 dim=-1) for _, raw in frames]
            graphs = [assemble_graph(state.norm, tm, u, spec)
                      for tm, (u, _) in zip(templates, frames)]

        def loss_fn():
            sq = cnt = 0.0
            for tm, graph, target, mask in zip(templates, graphs, targets, update_masks):
                pred = apply_mgn(state.params, graph, cfg.model, tm.row_offsets,
                                 tm.sender_perm, tm.sender_offsets)
                m = mask.to(pred.dtype)
                sq = sq + (((pred - target) ** 2).sum(dim=-1) * m).sum()
                cnt = cnt + m.sum()
            return sq / torch.clamp(cnt, min=1.0)

        return _gated_step(state, cfg.norm_steps, loss_fn)

    def train_window(state: TrainState, templates: Sequence[GraphTemplate],
                     fields: Sequence[Dict[str, torch.Tensor]], times: Sequence[torch.Tensor],
                     perms, generator: torch.Generator):
        losses = [one_batch_step(state, templates, fields, times, ts, generator)
                  for ts in np.asarray(perms)]
        return state, torch.stack(losses).float().cpu()

    return train_window
