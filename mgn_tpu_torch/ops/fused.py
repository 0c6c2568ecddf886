"""The processor rounds: kernels K2 (edge stage) and K3 (node stage), their
plain PyTorch versions, and the round loop.

The counterpart of ``mgn_tpu/ops/fused.py``: :func:`fused_process` runs the
``mps`` message-passing rounds that the TPU kernel ``_make_kernel`` runs in
one VMEM-resident call, as a host loop of three launches per round —
K2 ``edge_round`` -> K1 ``csr_segment_sum`` -> K3 ``node_round``
(``csrc/fused_round.cu``, ``csrc/csr_segment.cu``).  The banding plan, VMEM
budgeting and one-hot gathers of the TPU kernel have no counterpart: a GPU
gathers rows directly and keeps the state in device memory.

:func:`process_rounds_plain` is the plain reference, the counterpart of
``process_rounds_xla``: the same round math from plain PyTorch ops on any
device.  Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; any other device raises.

Forward only: the backward kernels (the TPU's ``_make_bwd_kernel``) come with
the training slice, so the kernel path refuses to run where autograd would
need a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

from mgn_tpu_torch.models.mlp import apply_mlp_parts
from mgn_tpu_torch.ops import _build
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_plain
from mgn_tpu_torch.ops.segment import gather

__all__ = ["edge_round", "edge_round_plain", "node_round", "node_round_plain",
           "fused_process", "process_rounds_plain", "round_params", "cast_mlp"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_LATENTS = (32, 64, 128, 256)  # the widths csrc/fused_round.cu is built for


# --- plain versions -----------------------------------------------------------

def edge_round_plain(e, v, senders, receivers, edge_valid, mlp) -> Tuple[torch.Tensor, torch.Tensor]:
    """One edge stage: ``msg = LN(MLP_e([e, v[s], v[r]])) * edge_valid``.
    Returns ``(e + msg, msg)`` in ``e``'s dtype (the compute dtype)."""
    cd = e.dtype
    msg = apply_mlp_parts(mlp, (e, gather(v, senders), gather(v, receivers)), cd)
    msg = msg * edge_valid
    return e + msg, msg


def node_round_plain(v, agg, mlp) -> torch.Tensor:
    """One node stage: ``v + LN(MLP_n([v, agg]))``, agg cast to ``v``'s dtype."""
    cd = v.dtype
    return v + apply_mlp_parts(mlp, (v, agg.to(cd)), cd)


def process_rounds_plain(proc_params, v0, e0, senders, receivers, edge_valid,
                         mps: int, cdtype, n_pad: int, return_edges: bool = False):
    """Reference processor rounds from plain PyTorch ops (the counterpart of
    ``process_rounds_xla``): per round, the edge stage, an f32 segment-sum
    cast to ``cdtype``, and the node stage."""
    v, e = v0.to(cdtype), e0.to(cdtype)
    for r in range(mps):
        e, msg = edge_round_plain(e, v, senders, receivers, edge_valid,
                                  round_params(proc_params["edge_mlp"], r))
        agg = csr_segment_sum_plain(msg, receivers, None, n_pad)
        v = node_round_plain(v, agg, round_params(proc_params["node_mlp"], r))
    return (v, e) if return_edges else v


# --- kernels ------------------------------------------------------------------

def round_params(mlp: Dict[str, Any], r: int) -> Dict[str, Any]:
    """Round ``r`` of a processor MLP whose leaves are stacked on ``(mps,)``."""
    return {"w": [w[r] for w in mlp["w"]], "b": [b[r] for b in mlp["b"]],
            "ln_scale": mlp["ln_scale"][r], "ln_bias": mlp["ln_bias"][r]}


def _mlp_struct(mlp: Dict[str, Any], cd: torch.dtype, device, parts: int,
                L: int) -> _build.MlpParams:
    """Check one round's weights and pack their pointers for the kernel."""
    n = len(mlp["w"])
    if not 1 <= n <= 8 or len(mlp["b"]) != n:
        raise ValueError(f"kernel MLPs take 1..8 layers, got {n}")
    shapes = [(parts * L, L)] + [(L, L)] * (n - 1)
    tensors = list(zip(mlp["w"], shapes)) + [(b, (L,)) for b in mlp["b"]]
    for t, shape in tensors:
        if t.dtype != cd or tuple(t.shape) != shape:
            raise ValueError(f"kernel weight must be {cd} {shape}, got {t.dtype} {tuple(t.shape)}")
    for t in (mlp["ln_scale"], mlp["ln_bias"]):
        if t.dtype != torch.float32 or tuple(t.shape) != (L,):
            raise ValueError("LayerNorm parameters must be f32 (L,)")
    for t in [t for t, _ in tensors] + [mlp["ln_scale"], mlp["ln_bias"]]:
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel weights must be contiguous, 16-byte aligned, on the data's device")
    p = _build.MlpParams()
    for i in range(n):
        p.w[i] = mlp["w"][i].data_ptr()
        p.b[i] = mlp["b"][i].data_ptr()
    p.ln_scale = mlp["ln_scale"].data_ptr()
    p.ln_bias = mlp["ln_bias"].data_ptr()
    p.n_layers = n
    return p


def _check_rows(name: str, t: torch.Tensor, rows: int, cd: torch.dtype, device) -> None:
    if (t.dtype != cd or t.device != device or not t.is_contiguous()
            or t.shape[0] != rows or t.data_ptr() % 16):
        raise ValueError(f"{name}: expected a contiguous, aligned {cd} tensor with "
                         f"{rows} rows on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _no_grad_needed(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the processor kernels are forward-only; the backward kernels come "
            "with the training slice (ROADMAP.md) — run under torch.no_grad()")


def edge_round(e, v, senders, receivers, edge_valid, mlp) -> torch.Tensor:
    """K2: one edge stage.  Updates ``e`` in place (``e += msg``) and returns
    ``msg``.  ``mlp`` is one round of the edge MLP with weights and biases
    already in the compute dtype (``e.dtype``) and f32 LayerNorm parameters.
    CUDA: counted in ``edge_round.launches``."""
    if e.device.type == "cpu":
        new_e, msg = edge_round_plain(e, v, senders, receivers, edge_valid, mlp)
        e.copy_(new_e)
        return msg
    if e.device.type != "cuda":
        raise ValueError(f"edge_round runs on cuda or cpu, not {e.device}")
    cd, dev = e.dtype, e.device
    if cd not in _DTYPE_CODES:
        raise TypeError(f"edge_round kernel takes f32 or bf16, got {cd}")
    n_edges, L = e.shape
    if L not in _KERNEL_LATENTS:
        raise ValueError(f"edge_round kernel is built for latents {_KERNEL_LATENTS}, got {L}")
    _no_grad_needed(e, v, *mlp["w"], *mlp["b"], mlp["ln_scale"], mlp["ln_bias"])
    _check_rows("e", e, n_edges, cd, dev)
    _check_rows("v", v, v.shape[0], cd, dev)
    if v.shape[1] != L:
        raise ValueError(f"v must be (N, {L}), got {tuple(v.shape)}")
    for name, idx in (("senders", senders), ("receivers", receivers)):
        _check_rows(name, idx, n_edges, torch.int32, dev)
    _check_rows("edge_valid", edge_valid, n_edges, cd, dev)
    if edge_valid.numel() != n_edges:
        raise ValueError("edge_valid must hold one value per edge")
    params = _mlp_struct(mlp, cd, dev, parts=3, L=L)
    msg = torch.empty_like(e)
    lib = _build.library("fused_round")
    rc = lib.mgn_edge_round(
        _DTYPE_CODES[cd], L, e.data_ptr(), msg.data_ptr(), v.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), edge_valid.data_ptr(), n_edges,
        ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_round")
    edge_round.launches += 1
    return msg


def node_round(v, agg, mlp) -> None:
    """K3: one node stage, ``v += LN(MLP_n([v, agg]))`` in place; ``agg`` is
    K1's f32 aggregate.  CUDA: counted in ``node_round.launches``."""
    if v.device.type == "cpu":
        v.copy_(node_round_plain(v, agg, mlp))
        return
    if v.device.type != "cuda":
        raise ValueError(f"node_round runs on cuda or cpu, not {v.device}")
    cd, dev = v.dtype, v.device
    if cd not in _DTYPE_CODES:
        raise TypeError(f"node_round kernel takes f32 or bf16, got {cd}")
    n_nodes, L = v.shape
    if L not in _KERNEL_LATENTS:
        raise ValueError(f"node_round kernel is built for latents {_KERNEL_LATENTS}, got {L}")
    _no_grad_needed(v, agg, *mlp["w"], *mlp["b"], mlp["ln_scale"], mlp["ln_bias"])
    _check_rows("v", v, n_nodes, cd, dev)
    _check_rows("agg", agg, n_nodes, torch.float32, dev)
    if tuple(agg.shape) != (n_nodes, L):
        raise ValueError(f"agg must be ({n_nodes}, {L}), got {tuple(agg.shape)}")
    params = _mlp_struct(mlp, cd, dev, parts=2, L=L)
    lib = _build.library("fused_round")
    rc = lib.mgn_node_round(_DTYPE_CODES[cd], L, v.data_ptr(), agg.data_ptr(), n_nodes,
                            ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "node_round")
    node_round.launches += 1


edge_round.launches = 0
node_round.launches = 0


def cast_mlp(mlp: Dict[str, Any], cd: torch.dtype) -> Dict[str, Any]:
    """Weights and biases to the compute dtype (as ``apply_mlp_parts`` casts
    them), LayerNorm parameters f32: the form :func:`edge_round` and
    :func:`node_round` take their weights in."""
    return {"w": [w.to(cd).contiguous() for w in mlp["w"]],
            "b": [b.to(cd).contiguous() for b in mlp["b"]],
            "ln_scale": mlp["ln_scale"].float().contiguous(),
            "ln_bias": mlp["ln_bias"].float().contiguous()}


def fused_process(proc_params, v0, e0, senders, receivers, row_offsets, edge_valid,
                  mps: int, return_edges: bool = False):
    """Run ``mps`` processor rounds; the compute dtype is ``v0.dtype``.

    ``proc_params`` is the stacked processor dict (``init_mgn``);
    ``edge_valid`` is ``(E_pad, 1)`` in the compute dtype.  CUDA: per round
    K2 -> K1 -> K3, updating copies of ``v0``/``e0`` in place.  CPU:
    :func:`process_rounds_plain`.  Returns ``v`` (and ``e`` with
    ``return_edges``).
    """
    n_pad = v0.shape[0]
    if v0.device.type == "cpu":
        return process_rounds_plain(proc_params, v0, e0, senders, receivers, edge_valid,
                                    mps, v0.dtype, n_pad, return_edges=return_edges)
    if v0.device.type != "cuda":
        raise ValueError(f"fused_process runs on cuda or cpu, not {v0.device}")
    cd = v0.dtype
    edge_mlp = cast_mlp(proc_params["edge_mlp"], cd)
    node_mlp = cast_mlp(proc_params["node_mlp"], cd)
    v, e = v0.clone(), e0.to(cd).clone()
    for r in range(mps):
        msg = edge_round(e, v, senders, receivers, edge_valid, round_params(edge_mlp, r))
        agg = csr_segment_sum(msg, receivers, row_offsets, n_pad)
        node_round(v, agg, round_params(node_mlp, r))
    return (v, e) if return_edges else v
