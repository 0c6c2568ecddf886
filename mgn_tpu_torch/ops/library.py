"""The serving kernels as PyTorch operators, under the namespace
``mgn_tpu_torch`` (``torch.ops.mgn_tpu_torch.*``).

One operator per kernel of the forward rounds, each with three
implementations:

- **CUDA**: the hand-written kernel, launched through ``ctypes``
  (:mod:`mgn_tpu_torch.ops.fused`' ``_*_cuda`` functions,
  :func:`mgn_tpu_torch.ops.csr_segment._launch`); it checks its inputs,
  reads their pointers, launches and counts the launch on the Python
  wrapper (``edge_round.launches`` ...).  It never runs the plain version,
  and builds its library at its first launch, not here: importing this
  module needs no ``nvcc``;
- **CPU**: the kernel's plain PyTorch version;
- **fake**: the outputs' shapes and dtypes alone, which is what
  ``torch.export`` runs while it traces.  So a traced forward holds the
  operators by name, reads no pointer, and counts no launch.

| operator | kernel | schema |
| --- | --- | --- |
| ``weight_streams`` | the weight-stream layout | ``(Tensor[] edge_mlp, Tensor[] node_mlp, bool adjoint, bool defer) -> (Tensor, Tensor, Tensor)`` |
| ``edge_project`` | K7 | ``(Tensor v, Tensor w0, Tensor? wstream, int r) -> (Tensor, Tensor)`` |
| ``edge_round`` | K2 | ``(Tensor(a!) e, Tensor p, Tensor q, Tensor senders, Tensor receivers, Tensor edge_valid, Tensor[] mlp, Tensor? wstream, int r, int width) -> Tensor`` |
| ``node_round`` | K3, and its ``node_extra`` form | ``(Tensor(a!) v, Tensor agg, Tensor[] mlp, Tensor? wstream, int r, Tensor? extra, int width) -> ()`` |
| ``csr_segment_sum`` | K1, and K1-perm | ``(Tensor data, Tensor row_offsets, int num_segments, Tensor? perm) -> Tensor`` |
| ``csr_segment_sum_out`` | the same into ``out`` | ``(..., Tensor(a!) out) -> ()`` |

An MLP travels as its flat leaves stacked on ``(rounds,)`` — ``w[0..n)``,
``b[0..n)``, ``ln_scale``, ``ln_bias`` — and ``r`` picks the round; the
streams are :func:`~mgn_tpu_torch.ops.fused.weight_streams`' ``(rounds, ·)``
tensors, of which a kernel reads round ``r``'s leading part.  ``width`` is
the model's width inside the tensors' tile width (their last dimension): a
processor of a width the kernels are not built for runs padded to the next
one (``ops/fused.fused_process``), and K2's and K3's LayerNorm runs over
the first ``width`` columns.  K2 updates
``e`` and K3 ``v`` in place, as their schemas declare (``Tensor(a!)``).
Importing any module of :mod:`mgn_tpu_torch.ops` registers the operators
(``ops/__init__.py``); a loaded serving artefact needs this module and
``torch`` alone.
"""

from __future__ import annotations

from typing import List

import torch

from mgn_tpu_torch.ops import csr_segment as _csr
from mgn_tpu_torch.ops import fused as _fused

__all__ = ["NAMESPACE", "SCHEMAS", "OPERATORS", "IMPLEMENTATIONS", "CUDA_IMPLEMENTATIONS"]

NAMESPACE = "mgn_tpu_torch"

SCHEMAS = {
    "weight_streams": "weight_streams(Tensor[] edge_mlp, Tensor[] node_mlp, bool adjoint, "
                      "bool defer) -> (Tensor, Tensor, Tensor)",
    "edge_project": "edge_project(Tensor v, Tensor w0, Tensor? wstream, int r) "
                    "-> (Tensor, Tensor)",
    "edge_round": "edge_round(Tensor(a!) e, Tensor p, Tensor q, Tensor senders, "
                  "Tensor receivers, Tensor edge_valid, Tensor[] mlp, Tensor? wstream, int r, "
                  "int width) -> Tensor",
    "node_round": "node_round(Tensor(a!) v, Tensor agg, Tensor[] mlp, Tensor? wstream, int r, "
                  "Tensor? extra, int width) -> ()",
    "csr_segment_sum": "csr_segment_sum(Tensor data, Tensor row_offsets, int num_segments, "
                       "Tensor? perm) -> Tensor",
    "csr_segment_sum_out": "csr_segment_sum_out(Tensor data, Tensor row_offsets, "
                           "int num_segments, Tensor? perm, Tensor(a!) out) -> ()",
}
OPERATORS = tuple(SCHEMAS)


def _round(leaves: List[torch.Tensor], r: int):
    """Round ``r`` of a stacked MLP's flat leaves, as the plain versions take it."""
    return _fused.round_params(_fused._mlp_dict(leaves), r)


# --- CPU: the plain versions ----------------------------------------------------

def _weight_streams_cpu(edge_mlp, node_mlp, adjoint, defer):
    em, nm = (_fused._mlp_dict(x) if x else None for x in (edge_mlp, node_mlp))
    first = (em or nm)["w"][0]
    missing = lambda: first.new_empty((first.shape[0], 0))
    return tuple(missing() if t is None else t
                 for t in _fused.weight_streams_plain(em, nm, adjoint, defer))


def _edge_project_cpu(v, w0, wstream, r):
    return _fused.edge_project_plain(v, {"w": [w0[r]]})


def _edge_round_cpu(e, p, q, senders, receivers, edge_valid, mlp, wstream, r, width):
    new_e, msg = _fused.edge_round_plain(e, p, q, senders, receivers, edge_valid,
                                         _round(mlp, r), width)
    e.copy_(new_e)
    return msg


def _node_round_cpu(v, agg, mlp, wstream, r, extra, width):
    v.copy_(_fused.node_round_plain(v, agg, _round(mlp, r), extra, width))


def _csr_segment_sum_cpu(data, row_offsets, num_segments, perm):
    return _csr.csr_segment_sum_plain(data, None, row_offsets, num_segments, perm)


def _csr_segment_sum_out_cpu(data, row_offsets, num_segments, perm, out):
    _csr.csr_segment_sum_plain(data, None, row_offsets, num_segments, perm, out)


# --- CUDA: the kernels (the rest are fused's ``_*_cuda`` and csr_segment's ``_launch``)

def _csr_segment_sum_out_cuda(data, row_offsets, num_segments, perm, out):
    _csr._launch(data, row_offsets, num_segments, perm, out)


# --- fake: shapes and dtypes ------------------------------------------------------

def _weight_streams_fake(edge_mlp, node_mlp, adjoint, defer):
    first = (edge_mlp or node_mlp)[0]
    L, rounds = first.shape[-1], first.shape[0]
    n_edge, n_node = ((len(x) - 2) // 2 for x in (edge_mlp, node_mlp))
    sizes = _fused._stream_sizes(L, first.dtype, n_edge, n_node, adjoint, defer)
    return tuple(first.new_empty((rounds, size if m else 0))
                 for m, size in zip((edge_mlp, node_mlp, edge_mlp), sizes))


def _edge_project_fake(v, w0, wstream, r):
    return (v.new_empty(v.shape, dtype=torch.float32),
            v.new_empty(v.shape, dtype=torch.float32))


def _edge_round_fake(e, p, q, senders, receivers, edge_valid, mlp, wstream, r, width):
    return torch.empty_like(e)


def _node_round_fake(v, agg, mlp, wstream, r, extra, width):
    return None


def _csr_segment_sum_fake(data, row_offsets, num_segments, perm):
    return data.new_empty((num_segments, data.shape[1]), dtype=torch.float32)


def _csr_segment_sum_out_fake(data, row_offsets, num_segments, perm, out):
    return None


CUDA_IMPLEMENTATIONS = {
    "weight_streams": _fused._weight_streams_cuda, "edge_project": _fused._edge_project_cuda,
    "edge_round": _fused._edge_round_cuda, "node_round": _fused._node_round_cuda,
    "csr_segment_sum": _csr._launch, "csr_segment_sum_out": _csr_segment_sum_out_cuda}
IMPLEMENTATIONS = {
    name: {"CPU": globals()[f"_{name}_cpu"], "CUDA": CUDA_IMPLEMENTATIONS[name],
           "fake": globals()[f"_{name}_fake"]}
    for name in OPERATORS}

_LIBRARY = torch.library.Library(NAMESPACE, "DEF")
for _name in OPERATORS:
    _LIBRARY.define(SCHEMAS[_name])
    for _key in ("CPU", "CUDA"):
        _LIBRARY.impl(_name, IMPLEMENTATIONS[_name][_key], _key)
    torch.library.register_fake(f"{NAMESPACE}::{_name}", IMPLEMENTATIONS[_name]["fake"],
                                lib=_LIBRARY)

