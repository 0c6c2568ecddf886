"""Feature normalizers: the port's copy of ``mgn_tpu/core/normalizers.py``
(forward, ``inverse``, ``Online.update``, :func:`accumulate`,
:func:`accumulate_tree`, and for graph-parallel training
:func:`accumulate_synced` and :func:`cross_replica_sync` over a
``torch.distributed`` group).

- ``OfflineMinMax`` — fixed affine map data-range -> target-range.
- ``OfflineMeanStd`` — fixed z-score.
- ``Online`` — running mean/std from accumulated sums, capped at ``max_acc``
  accumulation calls.

All operate on node-major tensors ``(..., dim)``.  Each is a dataclass of
tensors; :func:`normalizer_state` / :func:`normalizer_from_state` turn one into
a plain dict of tensors for checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import torch

__all__ = [
    "OfflineMinMax",
    "OfflineMeanStd",
    "Online",
    "Normalizer",
    "normalizers_from_meta",
    "normalizer_state",
    "normalizer_from_state",
    "accumulate",
    "accumulate_tree",
    "accumulate_synced",
    "accumulate_synced_all",
    "cross_replica_sync",
]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


class _Fields:
    """Shared helpers of the normalizer dataclasses."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class OfflineMinMax(_Fields):
    data_min: torch.Tensor
    data_max: torch.Tensor
    target_min: torch.Tensor
    target_max: torch.Tensor

    @classmethod
    def create(cls, data_min, data_max, target_min=0.0, target_max=1.0):
        return cls(_f32(data_min), _f32(data_max), _f32(target_min), _f32(target_max))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        scale = (self.target_max - self.target_min) / torch.clamp(
            self.data_max - self.data_min, min=1e-8)
        return (x - self.data_min) * scale + self.target_min

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        scale = (self.data_max - self.data_min) / torch.clamp(
            self.target_max - self.target_min, min=1e-8)
        return (y - self.target_min) * scale + self.data_min


@dataclasses.dataclass
class OfflineMeanStd(_Fields):
    mean: torch.Tensor
    std: torch.Tensor

    @classmethod
    def create(cls, mean, std):
        return cls(_f32(mean), _f32(std))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / torch.clamp(self.std, min=1e-8)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return y * torch.clamp(self.std, min=1e-8) + self.mean


@dataclasses.dataclass
class Online(_Fields):
    """Running mean/std from plain accumulated sums."""

    acc_count: torch.Tensor  # () f32 — number of accumulation calls
    num_accumulations: torch.Tensor  # () f32 — number of samples (rows) seen
    acc_sum: torch.Tensor  # (dim,) f32
    acc_sum_sq: torch.Tensor  # (dim,) f32
    max_acc: torch.Tensor  # () f32 — cap on accumulation calls
    std_epsilon: torch.Tensor  # () f32

    @classmethod
    def create(cls, dim: int, max_acc: float = 1e7, std_epsilon: float = 1e-8):
        return cls(
            acc_count=torch.zeros((), dtype=torch.float32),
            num_accumulations=torch.zeros((), dtype=torch.float32),
            acc_sum=torch.zeros((dim,), dtype=torch.float32),
            acc_sum_sq=torch.zeros((dim,), dtype=torch.float32),
            max_acc=_f32(max_acc),
            std_epsilon=_f32(std_epsilon),
        )

    @property
    def mean(self) -> torch.Tensor:
        n = torch.clamp(self.num_accumulations, min=1.0)
        return self.acc_sum / n

    @property
    def std(self) -> torch.Tensor:
        n = torch.clamp(self.num_accumulations, min=1.0)
        var = self.acc_sum_sq / n - (self.acc_sum / n) ** 2
        return torch.maximum(torch.sqrt(torch.clamp(var, min=0.0)), self.std_epsilon)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.std + self.mean

    def update(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> "Online":
        """Accumulate one batch ``x: (N, dim)``; ``mask: (N,)`` selects valid
        rows.  No-op once ``acc_count >= max_acc`` (the warm-up cap).
        Returns a new normalizer (as the JAX package does)."""
        if x.dim() == 1:
            x = x[:, None]
        x = x.float()
        m = (torch.ones((x.shape[0],), dtype=torch.float32, device=x.device) if mask is None
             else mask.reshape(-1).float())
        live = (self.acc_count < self.max_acc).float()
        w = (m * live)[:, None]
        return dataclasses.replace(
            self,
            acc_count=self.acc_count + live,
            num_accumulations=self.num_accumulations + live * m.sum(),
            acc_sum=self.acc_sum + (x * w).sum(dim=0),
            acc_sum_sq=self.acc_sum_sq + (x * x * w).sum(dim=0),
        )


Normalizer = Union[OfflineMinMax, OfflineMeanStd, Online]
_KINDS = {cls.__name__: cls for cls in (OfflineMinMax, OfflineMeanStd, Online)}


def accumulate(norm: Normalizer, x: torch.Tensor, mask=None, training: bool = True) -> Normalizer:
    """Update accumulator state if this is an online normalizer (else no-op)."""
    if isinstance(norm, Online) and training:
        return norm.update(x, mask)
    return norm


def accumulate_tree(norms: Mapping[str, Normalizer], batches: Mapping[str, torch.Tensor],
                    mask=None, training: bool = True) -> Dict[str, Normalizer]:
    """Accumulate every online normalizer in a dict against matching batches."""
    out = dict(norms)
    for k, v in batches.items():
        if k in out:
            out[k] = accumulate(out[k], v, mask, training)
    return out


def accumulate_synced_all(items, comm=None, training: bool = True) -> list:
    """:func:`accumulate_synced` of several ``(norm, x, mask)`` items with
    one ``all_reduce`` over ``comm`` (a :class:`~mgn_tpu_torch.parallel.mesh.
    Comm`) for all of them: each online normalizer's new masked row count,
    sum and sum of squares travel in one flat f32 buffer.  Returns the
    normalizers in order (offline ones unchanged)."""
    out = [n for n, _, _ in items]
    live_items = [(i, n, x, m) for i, (n, x, m) in enumerate(items)
                  if isinstance(n, Online) and training]
    if not live_items:
        return out
    if comm is None:
        for i, n, x, m in live_items:
            out[i] = n.update(x, m)
        return out
    parts = []
    for _, n, x, m in live_items:
        x = (x[:, None] if x.dim() == 1 else x).float()
        w = (torch.ones((x.shape[0],), dtype=torch.float32, device=x.device) if m is None
             else m.reshape(-1).float())
        parts += [w.sum().reshape(1), (x * w[:, None]).sum(0), (x * x * w[:, None]).sum(0)]
    flat = comm.all_reduce(torch.cat(parts))
    k = 0
    for i, n, _, _ in live_items:
        dim = n.acc_sum.shape[0]
        cnt, s, sq = flat[k], flat[k + 1:k + 1 + dim], flat[k + 1 + dim:k + 1 + 2 * dim]
        k += 1 + 2 * dim
        # acc_count advances once a call and is already the same on every rank
        live = (n.acc_count < n.max_acc).float()
        out[i] = dataclasses.replace(
            n, acc_count=n.acc_count + live,
            num_accumulations=n.num_accumulations + live * cnt,
            acc_sum=n.acc_sum + live * s, acc_sum_sq=n.acc_sum_sq + live * sq)
    return out


def accumulate_synced(norm: Normalizer, x: torch.Tensor, mask=None, comm=None,
                      training: bool = True) -> Normalizer:
    """Accumulate one batch with its sums summed over ``comm``'s ranks
    (a :class:`~mgn_tpu_torch.parallel.mesh.Comm`; None: plain
    :func:`accumulate`).

    The repeat-safe sibling of ``accumulate`` + :func:`cross_replica_sync`:
    only the new batch's masked sums cross the group, so already-synced
    state stays exact under any number of steps (every rank calls this the
    same number of times with its own rows of the batch).
    :func:`accumulate_synced_all` does several in one ``all_reduce``."""
    return accumulate_synced_all([(norm, x, mask)], comm, training)[0]


def cross_replica_sync(norm: Normalizer, comm) -> Normalizer:
    """Sum an online normalizer's accumulators over ``comm``'s ranks (the
    call count: the largest), for a one-time merge of separately
    accumulated state.

    **One-time merge only**: this sums the full accumulators, so applying it
    to already-synced state multiplies the sums by the group size, and
    repeated per-step syncing overflows f32 within ~40 steps (mean and std
    stay right until then, because numerator and denominator scale together).
    Inside a training step use :func:`accumulate_synced`, which sums only
    the new batch's contribution."""
    if not isinstance(norm, Online):
        return norm
    import torch.distributed as dist

    count = norm.acc_count.clone()
    dist.all_reduce(count, op=dist.ReduceOp.MAX, group=comm.group)
    flat = comm.all_reduce(torch.cat([norm.num_accumulations.reshape(1), norm.acc_sum,
                                      norm.acc_sum_sq]))
    dim = norm.acc_sum.shape[0]
    return dataclasses.replace(norm, acc_count=count, num_accumulations=flat[0],
                               acc_sum=flat[1:1 + dim], acc_sum_sq=flat[1 + dim:])


def normalizer_state(norm: Normalizer) -> Dict[str, Any]:
    """Plain dict of tensors (plus its ``kind``) for a checkpoint."""
    return {"kind": type(norm).__name__,
            **{f.name: getattr(norm, f.name) for f in dataclasses.fields(norm)}}


def normalizer_from_state(state: Mapping[str, Any]) -> Normalizer:
    fields = dict(state)
    kind = fields.pop("kind")
    if kind not in _KINDS:
        raise ValueError(f"unknown normalizer kind {kind!r}")
    return _KINDS[kind](**{k: _f32(v) for k, v in fields.items()})


def normalizers_from_meta(
    meta: Mapping[str, Any], max_norm_steps: float = 1e7
) -> tuple[int, Normalizer, Dict[str, Normalizer], Dict[str, Normalizer]]:
    """Build (quantities, edge_norm, node_norms, output_norms) from meta.json.

    - edge meta with data_min/max -> offline min-max; data_mean/std -> offline
      mean-std; otherwise online over ``dims + 1`` features.
    - bool features: min-max over [0, 1]; int one-hot features: min-max with
      optional target range remap, width ``data_max - data_min + 1``.
    - float features: offline min-max (with optional target remap) or offline
      mean-std when stats are present, else online; the output normalizer
      uses output_min/max (or output_mean/std) when present, else online.
    - mesh_pos and cells are skipped (not node features).
    """
    quantities = 0
    n_norms: Dict[str, Normalizer] = {}
    o_norms: Dict[str, Normalizer] = {}
    dims = meta["dims"]
    ndim = len(dims) if isinstance(dims, (list, tuple)) else int(dims)

    edges_meta = meta.get("edges")
    if edges_meta is not None and isinstance(edges_meta, Mapping):
        if "data_min" in edges_meta and "data_max" in edges_meta:
            e_norm: Normalizer = OfflineMinMax.create(
                edges_meta["data_min"], edges_meta["data_max"])
        elif "data_mean" in edges_meta and "data_std" in edges_meta:
            e_norm = OfflineMeanStd.create(
                edges_meta["data_mean"], edges_meta["data_std"])
        else:
            raise KeyError(
                "'edges' in metadata requires data_min/data_max or data_mean/data_std")
    else:
        e_norm = Online.create(ndim + 1, max_acc=max_norm_steps)

    target_features = meta.get("target_features", [])
    for feature in meta["feature_names"]:
        if feature in ("mesh_pos", "cells"):
            continue
        f = meta["features"][feature]
        dtype = f.get("dtype", "float32")
        is_target = feature in target_features
        if dtype == "bool":
            quantities += 1
            n_norms[feature] = OfflineMinMax.create(0.0, 1.0)
            if is_target:
                o_norms[feature] = OfflineMinMax.create(0.0, 1.0)
        elif dtype in ("int32", "int64"):
            if not f.get("onehot", False):
                raise ValueError(
                    f"integer feature '{feature}' must be onehot (as in the reference)")
            quantities += int(f["data_max"]) - int(f["data_min"]) + 1
            tmin = f.get("target_min", 0.0)
            tmax = f.get("target_max", 1.0)
            n_norms[feature] = OfflineMinMax.create(0.0, 1.0, tmin, tmax)
            if is_target:
                o_norms[feature] = OfflineMinMax.create(0.0, 1.0, tmin, tmax)
        else:
            dim = int(f["dim"])
            quantities += dim
            if "data_min" in f and "data_max" in f:
                n_norms[feature] = OfflineMinMax.create(
                    f["data_min"], f["data_max"],
                    f.get("target_min", 0.0), f.get("target_max", 1.0))
            elif "data_mean" in f and "data_std" in f:
                n_norms[feature] = OfflineMeanStd.create(f["data_mean"], f["data_std"])
            else:
                n_norms[feature] = Online.create(dim, max_acc=max_norm_steps)
            if is_target:
                if "output_min" in f and "output_max" in f:
                    o_norms[feature] = OfflineMinMax.create(
                        f["output_min"], f["output_max"],
                        f.get("target_min", 0.0), f.get("target_max", 1.0))
                elif "output_mean" in f and "output_std" in f:
                    o_norms[feature] = OfflineMeanStd.create(
                        f["output_mean"], f["output_std"])
                else:
                    o_norms[feature] = Online.create(dim, max_acc=max_norm_steps)
    return quantities, e_norm, n_norms, o_norms
