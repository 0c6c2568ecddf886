"""Shared training/rollout machinery: train and normalizer state, field
specs, masks, the normalized feature assembly and the loss — the port's copy
of ``mgn_tpu/train/common.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import GraphTemplate, MeshGraph

__all__ = ["NormState", "TrainState", "FieldSpec", "type_mask", "assemble_graph",
           "pack_fields", "unpack_fields", "masked_mse", "param_leaves"]


@dataclasses.dataclass
class NormState:
    """All normalizer state: edge + per-feature node + per-target output."""

    edge: N.Normalizer
    node: Dict[str, N.Normalizer]
    output: Dict[str, N.Normalizer]

    def to(self, device) -> "NormState":
        return NormState(
            edge=self.edge.to(device),
            node={k: v.to(device) for k, v in self.node.items()},
            output={k: v.to(device) for k, v in self.output.items()})

    def state_dict(self) -> Dict[str, Any]:
        return {"edge": N.normalizer_state(self.edge),
                "node": {k: N.normalizer_state(v) for k, v in self.node.items()},
                "output": {k: N.normalizer_state(v) for k, v in self.output.items()}}

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any]) -> "NormState":
        return cls(
            edge=N.normalizer_from_state(state["edge"]),
            node={k: N.normalizer_from_state(v) for k, v in state["node"].items()},
            output={k: N.normalizer_from_state(v) for k, v in state["output"].items()})


@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer, normalizers and step (``mgn_tpu``'s
    ``TrainState``).  ``params`` is the nested parameter dict whose leaves
    the ``torch.optim`` optimizer holds (in :func:`param_leaves` order);
    the optimizer updates them in place.  ``optimizer`` is None for a
    model-only state (serving checkpoints)."""

    params: Dict[str, Any]
    optimizer: Optional[torch.optim.Optimizer]
    norm: NormState
    step: int = 0


def param_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested parameter dict in a fixed order: dict keys
    sorted, lists in order — the order of ``jax.tree.leaves`` on the same
    tree, so optimizer state carries across (:mod:`mgn_tpu_torch.convert`)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of the dynamic node fields (order matters: node
    features are concatenated in ``feature_names`` order, then one-hot type)."""

    fields: Tuple[str, ...]  # dynamic input fields (feature_names minus mesh_pos/cells/node_type)
    target_fields: Tuple[str, ...]
    field_dims: Tuple[int, ...]
    target_dims: Tuple[int, ...]
    # per-target output semantics: 'delta' (finite-difference derivative) or
    # 'absolute' (the network predicts the value itself)
    output_modes: Tuple[str, ...] = ()

    @classmethod
    def from_meta(cls, meta: Dict[str, Any]) -> "FieldSpec":
        fields = tuple(f for f in meta["feature_names"]
                       if f not in ("mesh_pos", "node_type", "cells"))
        targets = tuple(meta["target_features"])
        return cls(
            fields=fields,
            target_fields=targets,
            field_dims=tuple(int(meta["features"][f]["dim"]) for f in fields),
            target_dims=tuple(int(meta["features"][f]["dim"]) for f in targets),
            output_modes=tuple(
                meta["features"][f].get("output_mode", "delta") for f in targets),
        )

    def mode(self, i: int) -> str:
        return self.output_modes[i] if self.output_modes else "delta"

    @property
    def output_dim(self) -> int:
        return sum(self.target_dims)

    def target_slices(self) -> List[slice]:
        out, off = [], 0
        for d in self.target_dims:
            out.append(slice(off, off + d))
            off += d
        return out


def type_mask(node_type: torch.Tensor, types: Sequence[int]) -> torch.Tensor:
    """True where node_type ∈ types. (Padded nodes have type -1 → False.)"""
    return torch.isin(node_type, torch.as_tensor(list(types), dtype=node_type.dtype,
                                                 device=node_type.device))


def pack_fields(values: Dict[str, torch.Tensor], spec: FieldSpec) -> torch.Tensor:
    """Stack target-field tensors into one (N, output_dim) slab."""
    return torch.cat([values[f] for f in spec.target_fields], dim=-1)


def unpack_fields(slab: torch.Tensor, spec: FieldSpec) -> Dict[str, torch.Tensor]:
    return {f: slab[..., sl] for f, sl in zip(spec.target_fields, spec.target_slices())}


def assemble_graph(
    norm: NormState,
    template: GraphTemplate,
    field_values: Dict[str, torch.Tensor],
    spec: FieldSpec,
) -> MeshGraph:
    """Normalized feature assembly into a MeshGraph (eval-mode normalizers)."""
    parts = [norm.node[f](field_values[f]) for f in spec.fields]
    parts.append(norm.node["node_type"](template.node_type_onehot))
    nf = torch.cat(parts, dim=-1) * template.node_mask[:, None]
    ef = norm.edge(template.mesh_edge_features) * template.edge_mask[:, None]
    return MeshGraph(
        node_features=nf,
        edge_features=ef,
        senders=template.senders,
        receivers=template.receivers,
        node_mask=template.node_mask,
        edge_mask=template.edge_mask,
    )


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of squared channel errors per node, averaged over masked nodes."""
    per_node = ((pred - target) ** 2).sum(dim=-1)
    m = mask.to(pred.dtype)
    return (per_node * m).sum() / torch.clamp(m.sum(), min=1.0)
