"""The processor rounds, forward and backward: kernels K7 (the first
layer's projections), K2 (edge stage), K3 (node stage), K4 (edge stage
backward), K5 (node stage backward) and K6 (weight gradients), their plain
PyTorch versions, and the round loops.

The counterpart of ``mgn_tpu/ops/fused.py``: :func:`fused_process` runs the
``mps`` message-passing rounds that the TPU kernel ``_make_kernel`` runs in
one VMEM-resident call, as a host loop of four launches per round —
K7 ``edge_project`` -> K2 ``edge_round`` -> K1 ``csr_segment_sum`` -> K3
``node_round`` (``csrc/fused_round.cu``, ``csrc/csr_segment.cu``) — after
one launch that lays out every round's weights for K7, K2 and K3
(:func:`weight_streams`).  The edge stage runs in the TPU kernel's
``preproject`` form (``mgn_tpu/ops/fused.py:453-463``, ``:493-503``): K7
projects the round's ``v`` through the edge MLP's first-layer sender and
receiver row blocks once, ``P = v·W0[L:2L]``, ``Q = v·W0[2L:3L]`` in f32,
and K2's first layer is ``(P[s] + Q[r]) + e·W0[0:L]``.  The JAX forward
takes that form where ``E ≥ N`` and two f32 ``(N, L)`` buffers fit VMEM,
which every mesh of the repo meets; the port takes it at every shape, on
CUDA and on the CPU (below ``E ≥ N`` the two forms differ only in
summation order).
Where a gradient is needed it runs as a ``torch.autograd.Function`` (the
JAX ``custom_vjp``): the forward saves each round's start-of-round ``v``,
``e`` and the compute-dtype aggregate in ``(mps, ·, L)`` residual stacks
(what the TPU forward saves with ``save_residuals``) and the weight streams,
laid out with K4's, K5's and K8's adjoint products too, and the backward
walks the rounds in reverse as ``_make_bwd_kernel`` does — per round K5
``node_round_bwd``, one grouped K6 ``wgrad`` call for the node MLP, K7 on
the round's saved ``v`` (the pre-projected recompute: the very kernel and
inputs the forward ran, so the same bits), then the edge stage's adjoint in
one of the TPU backward's two forms (``csrc/fused_round_bwd.cu``,
``csrc/wgrad.cu``):
- ``defer_first`` (``mgn_tpu/ops/fused.py:785-794``, ``:966-971``,
  ``:1071-1094``), taken where ``E >= N`` (every mesh of the repo) as the
  JAX backward takes it, or as ``_FORCE_DEFER`` pins it: K4
  ``edge_round_bwd`` stops at ``de`` and hands on the first layer's raw
  cotangent ``dh0``; K1 sums it by receiver into ``G_r`` and, through the
  template's sender permutation, by sender into ``G_s`` (f32 ``(N, L)``
  buffers made once per backward); K8 ``first_layer_adjoint`` adds
  ``rnd(G_s·W0[L:2L]ᵀ + G_r·W0[2L:3L]ᵀ)`` into ``dv``; one K6 call gives
  the edge MLP's gradients with ``dW0[L:2L] = vᵀ·G_s`` and ``dW0[2L:3L] =
  vᵀ·G_r`` as two ``N``-row products;
- otherwise K4 also writes the per-edge ``dvs``/``dvr``, K1 sums them by
  receiver and by sender into ``dv``, and K6 reads the first layer's
  ``v[s]``/``v[r]`` parts through the edge index.
Every round kernel and K6 run on the tensor cores
(bf16 directly, f32 through 3xTF32; ``csrc/mma_tile.cuh``); K2 and K4 share
one 64-edge tile (``csrc/edge_tile.cuh``), K3 and K5 one 16-node tile
(``csrc/node_tile.cuh``), K7 and K8 one column-sliced projection tile
(``csrc/proj_tile.cuh``, :func:`proj_plan`); K6 is one launch a group
on a full-width split-row tile whose row splits are added inside the
launch, in a fixed order, by the tile's co-resident blocks
(:func:`wgrad_plan`).  The banding plan,
VMEM budgeting and one-hot gathers of the TPU kernels have no counterpart: a
GPU gathers rows directly and keeps the state in device memory.

The cloth family's form (``node_extra``, the TPU kernels'
``_make_kernel(node_extra=True)`` and ``_make_bwd_kernel(node_extra=True)``):
an f32 ``(N, L)`` offset that K3 adds into the node MLP's first-layer
pre-activation — the world-edge aggregate's term, which the model computes
outside the rounds.  Serving passes it as a per-round hook (one
weight-stream launch for every round, forward only); training passes it as a
tensor to one ``mps=1`` call a round, as the JAX fused branch does, and the
backward's K5 recomputes with it and returns its cotangent ``dxtr`` (the
first layer's pre-activation cotangent) as that tensor's gradient.

Dtype rules (``mgn_tpu/ops/fused.py:_mlp_bwd``): cotangent carries in the
compute dtype, weight, bias and LayerNorm gradients in f32, LayerNorm
statistics in f32; biases rounded to the compute dtype as in
``apply_mlp_parts``.

:func:`process_rounds_plain` is the plain reference, the counterpart of
``process_rounds_xla``: the same round math from plain PyTorch ops on any
device, differentiated by ``torch.autograd``.  Each kernel wrapper launches
its kernel for CUDA tensors and runs its plain version for CPU tensors; any
other device raises.  So on the CPU :func:`fused_process` runs the same loops
and the same ``Function`` through the plain versions.  The forward's kernels
(``weight_streams``, K7, K2, K3, and K1 in ``ops/csr_segment.py``) are
PyTorch operators (:mod:`mgn_tpu_torch.ops.library`), whose CUDA
implementations are this module's ``_*_cuda`` functions: the forward loop
calls them on every device and so traces (``torch.export``); the backward's
kernels are called directly.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from mgn_tpu_torch.ops import _build
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_plain
from mgn_tpu_torch.ops.mlp_math import _dot, apply_mlp_parts
from mgn_tpu_torch.ops.segment import gather

__all__ = ["edge_project", "edge_project_plain", "edge_round", "edge_round_plain",
           "node_round", "node_round_plain",
           "weight_streams", "weight_streams_plain",
           "edge_round_bwd", "edge_round_bwd_plain", "node_round_bwd",
           "node_round_bwd_plain", "first_layer_adjoint", "first_layer_adjoint_plain",
           "wgrad", "wgrad_group", "wgrad_plain",
           "wgrad_plan", "wgrad_tile", "WgradProduct", "WgradPlan", "MlpSaved", "proj_plan",
           "edge_plan", "kernel_width",
           "fused_process", "process_rounds_plain", "round_params", "cast_mlp",
           "mlp_wgrads"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_LATENTS = (32, 64, 128, 256)  # the widths csrc/fused_round*.cu are built for
# (kernel_width: a model of another width up to 256 runs padded to the next)
# rows per group of the LayerNorm partial sums K4/K5 write: one 64-edge tile
# of K4 (EdgeTile::kRows in csrc/edge_tile.cuh), one 16-node tile of K5
# (NodeTile::kRows in csrc/node_tile.cuh)
_EDGE_BWD_ROWS = 64
_NODE_BWD_ROWS = 16
_STREAM_BF16_PAD = 8  # row padding of a bf16 ring stage of the edge tile (smem_pad_k)
_NODE_STREAM_PAD = 8  # row padding of K3's ring stages (NodeTile::PW)
# the projection tile of K7 and K8 (csrc/proj_tile.cuh): output columns a
# block owns (ProjLayout::CN, L where L < 64), the padding of its B image's
# rows (PB - CN), and rows a block owns (kProjectRows, kAdjointRows)
_PROJ_COLS = 64
_PROJ_PAD = 8
_PROJ_ROWS = {"edge_project": 64, "first_layer_adjoint": 32}
# K6 (csrc/wgrad.cu): rows per ring stage (kChunk), ring stages (kStages);
# a block's rows span at least _WGRAD_MIN_CHUNKS chunks where the rows
# allow; a group of fewer tile-rows than _WGRAD_SMALL takes 64-wide tiles;
# products a launch (kWgradMaxProducts); the counters kept per device
_WGRAD_CHUNK = 32
_WGRAD_STAGES = 4
_WGRAD_MIN_CHUNKS = 2
_WGRAD_SMALL = 4096
_WGRAD_MAX_PRODUCTS = 12
_WGRAD_COUNTERS = 4096
# K2 (csrc/edge_tile.cuh EdgeRing): the dynamic shared memory a block can
# have, alone and as one of two on an SM, its ring depths in order of
# preference, and the card's SMs
_MAX_SMEM = 232448
_PAIR_SMEM = 115712  # the same for each of two blocks an SM
_EDGE_STAGES = (4, 3, 2)
_SMS = 132
_FORCE_DEFER = None  # testing hook: pin the deferred first-layer backward (None: E >= N)


class MlpSaved(NamedTuple):
    """What K4/K5 (or their plain versions) hand to K6 for one MLP round."""

    dh: List[torch.Tensor]  # per layer: (rows, L) pre-activation cotangent, compute dtype
    post: List[torch.Tensor]  # per hidden layer: (rows, L) ReLU output, compute dtype
    ln: torch.Tensor  # (groups, 2L) f32: [sum dy*xhat | sum dy] per group of rows


# --- plain versions -----------------------------------------------------------

def edge_project_plain(v, mlp) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K7: the round's node state through the edge MLP's first-layer
    sender and receiver row blocks, ``P = v·W0[L:2L]`` and ``Q =
    v·W0[2L:3L]``, the raw f32 products (no bias, no rounding to the
    compute dtype ``v.dtype``: ``preferred_element_type=f32``)."""
    cd, L = v.dtype, v.shape[-1]
    w0 = mlp["w"][0]
    return _dot(v, w0[L:2 * L], cd), _dot(v, w0[2 * L:3 * L], cd)


def _projected(p, q, senders, receivers) -> torch.Tensor:
    """``P[s] + Q[r]`` per edge (f32): the first layer's pre-projected part."""
    return gather(p, senders) + gather(q, receivers)


def edge_round_plain(e, p, q, senders, receivers, edge_valid,
                     mlp, width: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One edge stage in the pre-projected form: ``msg = LN(MLP_e) *
    edge_valid`` with the first layer ``(P[s] + Q[r]) + e·W0[0:L]`` (the
    gathered f32 sum first, then the product added: ``_mlp_fwd(extra_acc=)``),
    ``p``/``q`` :func:`edge_project_plain`'s.  Returns ``(e + msg, msg)`` in
    ``e``'s dtype (the compute dtype).  ``width``: the LayerNorm's real width
    where ``L`` is a padded tile's (``layer_norm(width=)``; None: ``L``)."""
    cd, L = e.dtype, e.shape[-1]
    first = dict(mlp, w=[mlp["w"][0][:L], *mlp["w"][1:]])
    msg = apply_mlp_parts(first, (e,), cd, extra=_projected(p, q, senders, receivers),
                          width=width)
    msg = msg * edge_valid
    return e + msg, msg


def node_round_plain(v, agg, mlp, extra=None, width: Optional[int] = None) -> torch.Tensor:
    """One node stage: ``v + LN(MLP_n([v, agg]))``, agg cast to ``v``'s
    dtype; ``extra`` (f32 ``(N, L)``, or None) is added into the first
    layer's pre-activation before the bias (``apply_mlp_parts(extra=)``);
    ``width`` the LayerNorm's real width (None: ``L``)."""
    cd = v.dtype
    return v + apply_mlp_parts(mlp, (v, agg.to(cd)), cd, extra=extra, width=width)


def process_rounds_plain(proc_params, v0, e0, senders, receivers, edge_valid,
                         mps: int, cdtype, n_pad: int, return_edges: bool = False,
                         node_extra=None, preproject: bool = False):
    """Reference processor rounds from plain PyTorch ops (the counterpart of
    ``process_rounds_xla``): per round, the edge stage, an f32 segment-sum
    cast to ``cdtype``, and the node stage.  The edge stage's first layer is
    ``[e, v[s], v[r]]·W0`` in three parts, as ``process_rounds_xla`` runs
    it; with ``preproject``, the form :func:`fused_process` runs
    (:func:`edge_project_plain`, then :func:`edge_round_plain`).
    ``node_extra``: the per-round hook of :func:`fused_process`."""
    v, e = v0.to(cdtype), e0.to(cdtype)
    for r in range(mps):
        extra = None if node_extra is None else node_extra(r, v)
        em = round_params(proc_params["edge_mlp"], r)
        if preproject:
            e, msg = edge_round_plain(e, *edge_project_plain(v, em), senders, receivers,
                                      edge_valid, em)
        else:
            parts = (e, gather(v, senders), gather(v, receivers))
            msg = apply_mlp_parts(em, parts, cdtype) * edge_valid
            e = e + msg
        agg = csr_segment_sum_plain(msg, receivers, None, n_pad)
        v = node_round_plain(v, agg, round_params(proc_params["node_mlp"], r), extra)
    return (v, e) if return_edges else v


def _stream_chunk(L: int, cd: torch.dtype) -> Tuple[int, int]:
    """``(KC, values per chunk)`` of K2's weight stream (``EdgeTile`` in
    ``csrc/edge_tile.cuh``): chunks of 128 bytes of depth; f32 a TF32 high
    and a low plane of L x KC, bf16 L rows of KC padded to KC + 8."""
    kc = min(128 // (4 if cd == torch.float32 else 2), L)
    return kc, (2 * L * kc if cd == torch.float32 else L * (kc + _STREAM_BF16_PAD))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds it."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _edge_stream_plain(mlp, adjoint: bool, defer: bool) -> torch.Tensor:
    w = mlp["w"]
    cd, rounds, L = w[0].dtype, w[0].shape[0], w[0].shape[-1]
    kc, _ = _stream_chunk(L, cd)
    w0 = [w[0][:, p * L:(p + 1) * L] for p in range(3)]
    blocks = w0[:1] + list(w[1:])
    if adjoint:  # K4's: B = W^T of the hidden layers n-1 .. 1, then of W0's row blocks
        blocks += [x.transpose(-1, -2) for x in list(w[:0:-1]) + w0[:1 if defer else 3]]
    b = torch.stack(blocks, 1).reshape(rounds, len(blocks), L // kc, kc, L)  # [r, p, c, k, n]
    if cd == torch.float32:
        b = b.reshape(rounds, len(blocks), L // kc, kc // 4, 4, L // 8, 8)
        b = b.permute(0, 1, 2, 5, 3, 6, 4).reshape(rounds, len(blocks), L // kc, L * kc)
        hi = _tf32(b)
        out = torch.stack([hi, _tf32(b - hi)], dim=3)
    else:
        out = torch.nn.functional.pad(b.transpose(-1, -2), (0, _STREAM_BF16_PAD))
    return out.reshape(rounds, -1).contiguous()


def _node_stream_plain(mlp, adjoint: bool) -> torch.Tensor:
    w = mlp["w"]
    rounds, L = w[0].shape[0], w[0].shape[-1]
    blocks = [wi.reshape(rounds, -1, L) for wi in w]
    if adjoint:  # K5's: B = W^T of the hidden layers n-1 .. 1, then of W0's two row blocks
        blocks += [x.transpose(-1, -2) for x in
                   list(w[:0:-1]) + [w[0][:, p * L:(p + 1) * L] for p in range(2)]]
    rows = torch.cat(blocks, dim=1)
    return torch.nn.functional.pad(rows, (0, _NODE_STREAM_PAD)).reshape(rounds, -1).contiguous()


def _proj_stream_plain(mlp, adjoint: bool) -> torch.Tensor:
    w0 = mlp["w"][0]
    rounds, L = w0.shape[0], w0.shape[-1]
    cols = min(L, _PROJ_COLS)
    blocks = [w0[:, p * L:(p + 1) * L] for p in (1, 2)]
    if adjoint:  # K8's: B = W^T of W0's sender, then receiver row block
        blocks += [b.transpose(-1, -2) for b in blocks]
    b = torch.stack(blocks, 1).reshape(rounds, len(blocks), L, L // cols, cols)  # [r, p, k, s, n]
    b = torch.nn.functional.pad(b.transpose(2, 3), (0, _PROJ_PAD))  # [r, p, s, k, n + pad]
    return b.reshape(rounds, -1).contiguous()


def weight_streams_plain(em=None, nm=None, adjoint: bool = False, defer: bool = False):
    """Plain version of :func:`weight_streams`.  The edge stream, per round:
    the forward products' ``B[k][n]`` (the first layer's ``e`` row block of
    ``W0``, then each hidden ``W``) — with ``adjoint``, then K4's adjoint
    products, ``B = W^T`` of the hidden layers ``n-1 .. 1`` and of ``W0``'s
    three row blocks (with ``defer``, of its ``e`` row block alone: the
    ``defer_first`` backward reads no further) — cut into KC-deep chunks, each laid out as one ring
    stage of the edge tile — f32: ``[hi | lo]``, the TF32 split of the chunk
    in wgmma's core-matrix order ``(n / 8, k / 4, n % 8, k % 4)``; bf16:
    ``B`` transposed to rows ``n`` of KC values, zero-padded.  The node
    stream, per round: the rows ``B[k]`` of K3's products (``W0``'s rows,
    then each hidden ``W``'s) — with ``adjoint``, then K5's, ``B = W^T`` of
    the hidden layers ``n-1 .. 1`` and of ``W0``'s two row blocks — each
    zero-padded to ``L + 8``.  The projection stream (K7's), per round:
    ``B`` = the edge MLP's first-layer sender rows ``W0[L:2L]``, then its
    receiver rows ``W0[2L:3L]`` — with ``adjoint``, then K8's, ``B = W^T`` of
    the same two row blocks — each cut into column slices of ``min(L, 64)``
    columns, a slice laid out as its ``L`` rows zero-padded by 8 (one
    contiguous image, which the projection tile copies whole).
    Returns ``(edge, node, projection)``, each ``(rounds, values per
    round)`` in the weights' dtype, or None where its MLP (the edge MLP for
    the projection) is."""
    return (None if em is None else _edge_stream_plain(em, adjoint, defer),
            None if nm is None else _node_stream_plain(nm, adjoint),
            None if em is None else _proj_stream_plain(em, adjoint))


def _real(width: Optional[int], L: int) -> Optional[int]:
    """``width`` where it is narrower than the tile width ``L``, else None
    (the unpadded arithmetic)."""
    return None if width is None or width == L else width


def _mlp_recompute(mlp, parts: Sequence[torch.Tensor], cd, extra=None,
                   width: Optional[int] = None):
    """``apply_mlp_parts``' forward, keeping what its adjoint needs: the
    ReLU outputs (compute dtype) and the LayerNorm's ``xhat`` and ``rstd``
    (f32).  ``extra``: the f32 first-layer offset the forward added
    (``_mlp_fwd(extra_acc=)``), without which the recomputed ReLU masks
    would not be the forward's.  ``width``: the LayerNorm's real width
    (``layer_norm(width=)``): ``xhat`` is 0 past it."""
    w, b = mlp["w"], mlp["b"]
    h, off = (None if extra is None else extra.float()), 0
    for p in parts:
        d = p.shape[-1]
        c = _dot(p, w[0][off: off + d], cd)
        h = c if h is None else h + c
        off += d
    h = h.to(cd) + b[0].to(cd)
    posts = []
    for i in range(1, len(w)):
        h = torch.relu(h)
        posts.append(h)
        h = _dot(h, w[i], cd).to(cd) + b[i].to(cd)
    h32 = h.float()
    width = _real(width, h32.shape[-1])
    x = h32 if width is None else h32[:, :width]
    mean = x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x - mean).square().mean(dim=-1, keepdim=True) + 1e-5)
    xhat = (x - mean) * rstd
    if width is not None:
        xhat = torch.nn.functional.pad(xhat, (0, h32.shape[-1] - width))
    return posts, xhat, rstd


def _mlp_adjoint(mlp, dy, posts, xhat, rstd, cd, n_parts: int, width: Optional[int] = None):
    """The adjoint of ``apply_mlp_parts`` from the f32 cotangent ``dy`` of
    its LayerNorm output, as ``mgn_tpu/ops/fused.py:_mlp_bwd`` computes it.
    Returns (per-part input cotangents, per-layer pre-activation cotangents),
    all in the compute dtype.  ``width``: the LayerNorm's real width: the
    means run over it, and the cotangent is 0 past it."""
    w = mlp["w"]
    L = xhat.shape[-1]
    width = _real(width, L)
    dxhat = dy * mlp["ln_scale"].float()
    if width is not None:
        dxhat, xhat = dxhat[:, :width], xhat[:, :width]
    dh = ((dxhat - dxhat.mean(dim=-1, keepdim=True)
           - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True)) * rstd)
    if width is not None:
        dh = torch.nn.functional.pad(dh, (0, L - width))
    dh = dh.to(cd)
    dhs = [dh] * len(w)
    for i in range(len(w) - 1, 0, -1):
        dh = _dot(dh, w[i].t(), cd).to(cd) * (posts[i - 1] > 0).to(cd)
        dhs[i - 1] = dh
    dparts = [_dot(dh, w[0][p * L: (p + 1) * L].t(), cd).to(cd) for p in range(n_parts)]
    return dparts, dhs


def _ln_partials(dy, xhat, rows_per_group: int, width: Optional[int] = None) -> torch.Tensor:
    """``[dy * xhat | dy]`` summed over consecutive groups of rows: the
    layout of the per-tile partial sums K4/K5 write (0 in the columns past
    the real ``width``)."""
    width = _real(width, dy.shape[-1])
    if width is not None:
        dy = torch.nn.functional.pad(dy[:, :width], (0, dy.shape[-1] - width))
    g = torch.cat([dy * xhat, dy], dim=-1)
    pad = -g.shape[0] % rows_per_group
    if pad:
        g = torch.cat([g, g.new_zeros((pad, g.shape[1]))])
    return g.view(-1, rows_per_group, g.shape[1]).sum(dim=1)


def edge_round_bwd_plain(de, dagg, e, p, q, senders, receivers, edge_valid, mlp,
                         defer: bool = False, width: Optional[int] = None):
    """Plain K4, the reverse of one edge stage at the round's saved ``e``
    and the projections ``p``/``q`` of its saved ``v``
    (:func:`edge_project_plain`): ``dmsg = (de + dagg[receivers]) *
    edge_valid`` through the edge MLP recomputed as :func:`edge_round_plain`
    runs it.  Returns ``(de + de_part, dvs, dvr, MlpSaved)``; with ``defer``
    (the ``defer_first`` form) ``(de + de_part, MlpSaved)``: no per-edge
    ``dvs``/``dvr``, the first layer's raw cotangent ``dh0`` (compute dtype)
    being ``MlpSaved.dh[0]``.  ``width``: the LayerNorm's real width (None:
    ``L``)."""
    cd = e.dtype
    posts, xhat, rstd = _mlp_recompute(mlp, (e,), cd, _projected(p, q, senders, receivers),
                                       width)
    dmsg = (de + gather(dagg, receivers).to(cd)) * edge_valid
    dy = dmsg.float()
    (de_p, *dvx), dhs = _mlp_adjoint(mlp, dy, posts, xhat, rstd, cd, 1 if defer else 3, width)
    saved = MlpSaved(dhs, posts, _ln_partials(dy, xhat, _EDGE_BWD_ROWS, width))
    return (de + de_p, *dvx, saved)


def first_layer_adjoint_plain(dv, g_s, g_r, mlp) -> torch.Tensor:
    """Plain K8, the end of a ``defer_first`` round: ``dv + rnd(G_s·W_sᵀ +
    G_r·W_rᵀ)``, ``W_s``/``W_r`` the edge MLP's first-layer sender and
    receiver row blocks ``W0[L:2L]``/``W0[2L:3L]`` (compute dtype, exact in
    f32), ``G_s``/``G_r`` the f32 ``(N, L)`` sums of the first layer's
    cotangent ``dh0`` by sender and by receiver; both products and their sum
    in f32, in that order, rounded once to ``dv``'s dtype (the compute
    dtype) before the add, as ``mgn_tpu/ops/fused.py:1071-1088`` adds them."""
    cd, L = dv.dtype, dv.shape[-1]
    w0 = mlp["w"][0].float()
    return dv + (g_s @ w0[L:2 * L].t() + g_r @ w0[2 * L:3 * L].t()).to(cd)


def node_round_bwd_plain(dv, v, agg, mlp, extra=None, width: Optional[int] = None):
    """Plain K5, the reverse of one node stage at the round's saved ``v`` and
    compute-dtype ``agg``: the update's cotangent is ``dv``.  Returns
    ``(dv + dv_part, dagg (f32), MlpSaved)``.  ``extra``: the round's f32
    ``(N, L)`` first-layer offset (``node_extra``); with it the recompute
    starts from it and a fourth output, ``dxtr``, is its cotangent — the
    first layer's pre-activation cotangent in the compute dtype, stored f32
    (``dh_node.astype(f32)`` of the TPU backward).  ``width``: the
    LayerNorm's real width (None: ``L``)."""
    cd = v.dtype
    posts, xhat, rstd = _mlp_recompute(mlp, (v, agg), cd, extra, width)
    dy = dv.float()
    (dv_p, dagg), dhs = _mlp_adjoint(mlp, dy, posts, xhat, rstd, cd, 2, width)
    out = (dv + dv_p, dagg.float(),
           MlpSaved(dhs, posts, _ln_partials(dy, xhat, _NODE_BWD_ROWS, width)))
    return out if extra is None else out + (dhs[0].float(),)


def wgrad_plain(dh, x=None, idx=None):
    """Plain K6: ``(x[idx]ᵀ @ dh or None, column sums of dh)``, f32."""
    dw = None
    if x is not None:
        xr = x if idx is None else x.index_select(0, idx)
        dw = xr.float().t() @ dh.float()
    return dw, dh.float().sum(dim=0)


# --- kernels ------------------------------------------------------------------

def round_params(mlp: Dict[str, Any], r: int) -> Dict[str, Any]:
    """Round ``r`` of a processor MLP whose leaves are stacked on ``(mps,)``."""
    return {"w": [w[r] for w in mlp["w"]], "b": [b[r] for b in mlp["b"]],
            "ln_scale": mlp["ln_scale"][r], "ln_bias": mlp["ln_bias"][r]}


def _check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a {dtype} {tuple(shape)} tensor on {device}, "
                         f"got {t!r}")
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {dtype} "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _bwd_struct(saved: MlpSaved) -> _build.BwdParams:
    """The output buffers of K4/K5 for one MLP round."""
    q = _build.BwdParams()
    for i, d in enumerate(saved.dh):
        q.dh[i] = d.data_ptr()
    for i, p in enumerate(saved.post):
        q.post[i] = p.data_ptr()
    q.ln_part = saved.ln.data_ptr()
    return q


def _check_rows(name: str, t: torch.Tensor, rows: int, cd: torch.dtype, device) -> None:
    if (t.dtype != cd or t.device != device or not t.is_contiguous()
            or t.shape[0] != rows or t.data_ptr() % 16):
        raise ValueError(f"{name}: expected a contiguous, aligned {cd} tensor with "
                         f"{rows} rows on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_setup(name: str, x: torch.Tensor, *params) -> Tuple[torch.dtype, int]:
    """Device, dtype and width checks shared by the round kernels; refuses
    tensors that need a gradient (the kernels are differentiated only
    through :func:`fused_process`'s ``Function``).  The width is the tile's,
    ``x``'s last dimension, one the kernels are built for (the model's
    width inside it goes to :func:`_packed_rounds`, which checks it)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes f32 or bf16, got {x.dtype}")
    if x.shape[-1] not in _KERNEL_LATENTS:
        raise ValueError(f"{name} kernel is built for latents {_KERNEL_LATENTS}, "
                         f"got {x.shape[-1]}: fused_process pads other widths to them")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in params):
        raise RuntimeError(f"{name} is not differentiable on its own: call fused_process, "
                           "whose autograd Function runs the backward kernels")
    return x.dtype, x.shape[-1]


def _mlp_tensors(mlp) -> List[torch.Tensor]:
    return [*mlp["w"], *mlp["b"], mlp["ln_scale"], mlp["ln_bias"]]


def _packed_rounds(mlp, cd: torch.dtype, device, parts: int, L: int,
                   real: Optional[int] = None) -> List[_build.MlpParams]:
    """The kernel parameters of every round of a cast MLP stacked on
    ``(rounds,)``, its tensors checked once: round ``r`` starts ``r``
    entries into each stack, so the host-bound forward slices and checks no
    tensor per launch.  The one builder of ``MlpParams``: a single round
    goes through it as a one-round stack (:func:`_round_struct`).  ``L`` is
    the tile width, ``real`` (None: ``L``) the model's width inside it,
    which the LayerNorm's statistics run over."""
    w, b = mlp["w"], mlp["b"]
    n = len(w)
    real = L if real is None else real
    if not 1 <= n <= 8 or len(b) != n:
        raise ValueError(f"kernel MLPs take 1..8 layers, got {n}")
    if not 1 <= real <= L:
        raise ValueError(f"a real width of {real} in a tile of {L}")
    stacks = [*w, *b, mlp["ln_scale"], mlp["ln_bias"]]
    names = ([f"w[{i}]" for i in range(n)] + [f"b[{i}]" for i in range(n)]
             + ["ln_scale", "ln_bias"])
    count = w[0].shape[0]
    shapes = ([(count, parts * L, L)] + [(count, L, L)] * (n - 1) + [(count, L)] * (n + 2))
    for i, (t, shape) in enumerate(zip(stacks, shapes)):
        _check_tensor(names[i], t, shape, cd if i < 2 * n else torch.float32, device)
    base = [(t.data_ptr(), t.stride(0) * t.element_size()) for t in stacks]
    out = []
    for r in range(count):
        p = _build.MlpParams()
        for i in range(n):
            p.w[i] = base[i][0] + r * base[i][1]
            p.b[i] = base[n + i][0] + r * base[n + i][1]
        p.ln_scale = base[2 * n][0] + r * base[2 * n][1]
        p.ln_bias = base[2 * n + 1][0] + r * base[2 * n + 1][1]
        p.n_layers = n
        p.real = real
        out.append(p)
    return out


def _round_struct(mlp, cd: torch.dtype, device, parts: int, L: int,
                  real: Optional[int] = None) -> _build.MlpParams:
    """One round's kernel parameters (``mlp`` as :func:`round_params` gives
    it): :func:`_packed_rounds` on a one-round stack."""
    one = {"w": [w[None] for w in mlp["w"]], "b": [b[None] for b in mlp["b"]],
           "ln_scale": mlp["ln_scale"][None], "ln_bias": mlp["ln_bias"][None]}
    return _packed_rounds(one, cd, device, parts, L, real)[0]


def _stream_sizes(L: int, cd: torch.dtype, n_edge: int, n_node: int,
                  adjoint: bool = False, defer: bool = False) -> Tuple[int, int, int]:
    """Values per round of the edge stream (K2's ``n_edge`` products; with
    ``adjoint`` K4's ``n_edge + 2`` too, or ``n_edge`` with ``defer``), of
    the node stream (K3's; with ``adjoint`` K5's too, as many again) and of
    the projection stream (K7's two ``(L, L)`` blocks in column slices; with
    ``adjoint`` K8's two too)."""
    kc, per = _stream_chunk(L, cd)
    twice = 2 if adjoint else 1
    cols = min(L, _PROJ_COLS)
    edge_products = n_edge + (n_edge + (0 if defer else 2) if adjoint else 0)
    return (edge_products * (L // kc) * per,
            (1 + n_node) * twice * L * (L + _NODE_STREAM_PAD),
            2 * twice * (L // cols) * L * (cols + _PROJ_PAD))


def proj_plan(n_rows: int, L: int, dtype: torch.dtype, kernel: str) -> Dict[str, Any]:
    """The launch of K7 (``kernel`` "edge_project") or K8
    ("first_layer_adjoint") on the projection tile (``ProjTile`` in
    ``csrc/proj_tile.cuh``) at ``n_rows`` rows: a block owns ``rows`` rows
    and a ``cols``-column slice of one output (K7: of ``P`` or of ``Q``; K8:
    of ``dv``, both products, each on its own warps of 16 x 32); ``grid``
    is ``(row tiles, slices [x 2 for K7])``; ``smem`` the block's shared
    memory in bytes (16 mbarriers, the B images of its products, A's padded
    rows — K7 ``v`` in ``dtype``, K8 ``[G_s | G_r]`` in f32 — and K8's f32
    rows where the two products meet); ``copied`` the bytes a call copies
    into shared memory, every block's B images and A rows."""
    rows, cols = _PROJ_ROWS[kernel], min(L, _PROJ_COLS)
    parts = 2 if kernel == "first_layer_adjoint" else 1
    b_size = 4 if dtype == torch.float32 else 2
    a_size = 4 if parts == 2 else b_size
    image = L * (cols + _PROJ_PAD) * b_size
    grid = (-(-n_rows // rows), (L // cols) * (1 if parts == 2 else 2))
    blocks = grid[0] * grid[1]
    return dict(rows=rows, cols=cols, grid=grid, blocks=blocks,
                threads=32 * parts * (rows // 16) * (cols // 32),
                smem=(16 * 8 + parts * image + rows * (parts * L + 16 // a_size) * a_size
                      + (rows * (cols + 8) * 4 if parts == 2 else 0)),
                copied=blocks * parts * (image + rows * L * a_size))


def edge_plan(n_edges: int, L: int, dtype: torch.dtype, n_layers: int = 3) -> Dict[str, Any]:
    """K2's launch at ``n_edges`` rows (``EdgeRing`` in ``csrc/edge_tile.cuh``;
    ``mgn_edge_round_plan`` gives the kernel's own numbers on the card): a
    block owns one tile of 64 rows (block ``b`` rows ``64 b ..``) in
    ``col_groups`` warpgroup column groups (``threads``), with a ring of
    ``stages`` weight chunks of ``stage_bytes``, in ``smem`` bytes of
    dynamic shared memory (two blocks an SM where ``smem`` is at most
    115,712 bytes); ``grid`` blocks, one a tile, so ``waves`` is ``grid``
    over 132 SMs at ``blocks_per_sm``, rounded up.  ``l2_weight_bytes``:
    the weight bytes a launch of ``n_layers`` products copies from L2, once
    per block."""
    f32 = dtype == torch.float32
    b = 4 if f32 else 2
    col_groups = (2 if L >= 256 else 1) if f32 else (L // 64 if L >= 128 else 1)
    threads = 128 * col_groups
    kc, per = _stream_chunk(L, dtype)
    stage = per * b
    red = col_groups * 64 * 8 if col_groups > 1 else 0
    size = lambda stages: stages * stage + 64 * (L + (4 if f32 else 8)) * b + red + 3 * 64 * 4 \
        + 8 * stages
    room = _PAIR_SMEM if threads <= 256 else _MAX_SMEM
    stages = next(s for s in _EDGE_STAGES if s == 2 or size(s) <= room)
    per_sm = 2 if size(stages) <= _PAIR_SMEM else 1
    grid = -(-n_edges // 64)
    return dict(col_groups=col_groups, stages=stages, threads=threads, smem=size(stages),
                stage_bytes=stage, grid=grid, blocks_per_sm=per_sm,
                waves=-(-grid // (_SMS * per_sm)), chunks=L // kc,
                l2_weight_bytes=grid * n_layers * (L // kc) * stage)


def _mlp_dict(leaves: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """The MLP of :func:`_mlp_tensors`' flat leaf list, back as a dict."""
    n = (len(leaves) - 2) // 2
    return {"w": list(leaves[:n]), "b": list(leaves[n:2 * n]), "ln_scale": leaves[2 * n],
            "ln_bias": leaves[2 * n + 1]}


def _one_round(mlp) -> List[torch.Tensor]:
    """One round's MLP (:func:`round_params`) as a one-round stack of leaves,
    the form the operators take."""
    return [t[None] for t in _mlp_tensors(mlp)]


def _on_cuda_or_cpu(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def weight_streams(em=None, nm=None, adjoint: bool = False, defer: bool = False):
    """K2's, K3's and K7's weights for every round of the cast edge and node
    MLPs (:func:`cast_mlp` of the processor's, stacked on ``(rounds,)``),
    laid out as the kernels' ring stages (see :func:`weight_streams_plain`)
    in one launch; with ``adjoint`` each round's edge stream also holds K4's
    adjoint products (with ``defer`` only those the ``defer_first`` form
    reads), its node stream K5's and its projection stream K8's.
    Returns ``(edge, node, projection)``; row ``r`` of each is round ``r``'s
    ``wstream`` for :func:`edge_round` / :func:`node_round` /
    :func:`edge_project` (where made with ``adjoint``: the row's leading
    forward part) and, made with ``adjoint``, :func:`edge_round_bwd` /
    :func:`node_round_bwd` / :func:`first_layer_adjoint` (the projection
    row's part past K7's); either
    MLP may be None (the edge MLP's None: no edge and no projection stream).
    Made once per :func:`fused_process` call, never cached: training
    changes the weights at every step.  The operator
    ``torch.ops.mgn_tpu_torch.weight_streams``: CUDA counted in
    ``weight_streams.launches``; CPU the plain version."""
    _on_cuda_or_cpu("weight_streams", (em or nm)["w"][0])
    out = torch.ops.mgn_tpu_torch.weight_streams(
        [] if em is None else _mlp_tensors(em), [] if nm is None else _mlp_tensors(nm),
        adjoint, defer)
    return tuple(None if m is None else t for m, t in zip((em, nm, em), out))


def edge_project(v, mlp, wstream) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: ``(P, Q)``, the f32 ``(N, L)`` projections of the round's node
    state ``v`` through the edge MLP's first-layer sender and receiver row
    blocks (see :func:`edge_project_plain`).  ``mlp`` is one round of the
    cast edge MLP, ``wstream`` the round's row of :func:`weight_streams`'
    projection stream, which holds the same weights laid out for the
    kernel (made with ``adjoint``: its leading part is read).  A fixed
    summation order: the same ``v`` gives the same bits.  The operator
    ``torch.ops.mgn_tpu_torch.edge_project`` on a one-round stack.  CPU:
    the plain version, which reads no ``wstream`` (None will do).  CUDA:
    counted in ``edge_project.launches``."""
    _on_cuda_or_cpu("edge_project", v)
    row = _forward_row("edge_project", wstream, _stream_sizes(v.shape[-1], v.dtype, 0, 0)[2])
    return torch.ops.mgn_tpu_torch.edge_project(v, mlp["w"][0][None], row, 0)


def edge_round(e, p, q, senders, receivers, edge_valid, mlp, wstream,
               width: Optional[int] = None) -> torch.Tensor:
    """K2: one edge stage in the pre-projected form (see
    :func:`edge_round_plain`).  Updates ``e`` in place (``e += msg``) and
    returns ``msg``.  ``p``/``q`` are :func:`edge_project`'s f32 ``(N, L)``
    projections of the round's ``v``; ``mlp`` is one round of the edge MLP
    with weights and biases already in the compute dtype (``e.dtype``) and
    f32 LayerNorm parameters; ``wstream`` the forward part of the round's
    row of :func:`weight_streams`' edge stream (made with ``adjoint``, the
    row's leading part); ``width`` the model's width inside the tile
    ``e.shape[-1]`` (None: the tile's; see :func:`fused_process`).  The
    operator ``torch.ops.mgn_tpu_torch.edge_round`` on a one-round stack.
    CPU: the plain version, which reads no ``wstream`` (None will do).
    CUDA: counted in ``edge_round.launches``."""
    _on_cuda_or_cpu("edge_round", e)
    row = _forward_row("edge_round", wstream,
                       _stream_sizes(e.shape[-1], e.dtype, len(mlp["w"]), 0)[0])
    return torch.ops.mgn_tpu_torch.edge_round(e, p, q, senders, receivers, edge_valid,
                                              _one_round(mlp), row, 0,
                                              e.shape[-1] if width is None else width)


def node_round(v, agg, mlp, wstream, extra=None, width: Optional[int] = None) -> None:
    """K3: one node stage, ``v += LN(MLP_n([v, agg]))`` in place; ``agg`` is
    K1's f32 aggregate; ``wstream`` the round's row of
    :func:`weight_streams`' node stream (made with ``adjoint``: its leading
    forward part); ``extra`` None or the round's f32 ``(N, L)`` first-layer
    offset (``node_extra``); ``width`` as for :func:`edge_round`.  The
    operator ``torch.ops.mgn_tpu_torch.node_round`` on a one-round stack.
    CPU: the plain version, which reads no ``wstream`` (None will do).
    CUDA: counted in ``node_round.launches``, or with ``extra`` in
    ``node_round.extra_launches``."""
    _on_cuda_or_cpu("node_round", v)
    row = _forward_row("node_round", wstream,
                       _stream_sizes(v.shape[-1], v.dtype, 0, len(mlp["w"]))[1])
    torch.ops.mgn_tpu_torch.node_round(v, agg, _one_round(mlp), row, 0, extra,
                                       v.shape[-1] if width is None else width)


def _forward_row(name: str, wstream: Optional[torch.Tensor],
                 size: int) -> Optional[torch.Tensor]:
    """A round's stream row as the operators' one-round stack: exactly the
    ``size`` values of its forward part (a caller slices a row made with
    ``adjoint``), or None (the CPU's plain versions read no stream)."""
    if wstream is None:
        return None
    if tuple(wstream.shape) != (size,):
        raise ValueError(f"{name}: expected the ({size},) forward part of a stream row, got "
                         f"{tuple(wstream.shape)}")
    return wstream[None]


# --- the serving operators' CUDA implementations (registered by ops/library.py) ---
# Every data_ptr() of the serving path is read here, below the operators: a
# traced call (torch.export) sees fake tensors and reaches none of it.

_PACKED: "collections.OrderedDict[Any, List[_build.MlpParams]]" = collections.OrderedDict()
_PACKED_ENTRIES = 64  # stacks whose packed parameters are kept


def _packed(leaves: Sequence[torch.Tensor], cd: torch.dtype, device, parts: int,
            L: int, real: Optional[int] = None) -> List[_build.MlpParams]:
    """:func:`_packed_rounds` of the stacked MLP whose flat leaves are
    ``leaves`` (:func:`_mlp_tensors` order), kept by the real width and the
    stacks' pointers, dtypes, shapes and strides: the host-bound forward
    checks and packs a processor's stacks once, at its first launch, and
    its later launches look them up."""
    key = (parts, L, real, cd, device,
           tuple((t.data_ptr(), t.dtype, t.shape, t.stride()) for t in leaves))
    packed = _PACKED.get(key)
    if packed is None:
        packed = _PACKED[key] = _packed_rounds(_mlp_dict(leaves), cd, device, parts, L, real)
        if len(_PACKED) > _PACKED_ENTRIES:
            _PACKED.popitem(last=False)
    return packed


def _round_params(packed: List[_build.MlpParams], r: int) -> _build.MlpParams:
    if not 0 <= r < len(packed):
        raise ValueError(f"round {r} of a {len(packed)}-round stack")
    return packed[r]


def _stream_row(wstream: Optional[torch.Tensor], r: int, size: int, cd: torch.dtype,
                device) -> torch.Tensor:
    """Round ``r``'s leading ``size`` values of a ``(rounds, ·)`` stream."""
    if wstream is None or wstream.dim() != 2 or not 0 <= r < wstream.shape[0] \
            or wstream.shape[1] < size:
        raise ValueError(f"wstream: expected a (rounds > {r}, >= {size}) weight stream, got "
                         f"{None if wstream is None else tuple(wstream.shape)}")
    row = wstream[r, :size]
    _check_tensor("wstream", row, (size,), cd, device)
    return row


def _weight_streams_cuda(edge: List[torch.Tensor], node: List[torch.Tensor], adjoint: bool,
                         defer: bool):
    """``weight_streams``' CUDA implementation: one launch."""
    em, nm = (_mlp_dict(x) if x else None for x in (edge, node))
    first = (em or nm)["w"][0]
    cd, L = _kernel_setup("weight_streams", first, *[w for m in (em, nm) if m for w in m["w"]])
    dev, rounds = first.device, first.shape[0]
    pe = None if em is None else _packed(edge, cd, dev, 3, L)[0]
    pn = None if nm is None else _packed(node, cd, dev, 2, L)[0]
    sizes = _stream_sizes(L, cd, len(em["w"]) if em else 0, len(nm["w"]) if nm else 0, adjoint,
                          defer)
    out_e, out_n, out_p = (torch.empty((rounds, size if m else 0), dtype=cd, device=dev)
                           for m, size in zip((em, nm, em), sizes))
    ptr = lambda m, t: None if m is None else t.data_ptr()
    lib = _build.library("fused_round")
    rc = lib.mgn_weight_streams(
        _DTYPE_CODES[cd], L, None if pe is None else ctypes.byref(pe),
        None if pn is None else ctypes.byref(pn), rounds, 0 if not adjoint else 2 if defer else 1,
        ptr(em, out_e), ptr(nm, out_n), ptr(em, out_p),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "weight_streams")
    weight_streams.launches += 1
    return out_e, out_n, out_p


def _edge_project_cuda(v, w0, wstream, r: int):
    """``edge_project``'s CUDA implementation: K7 on round ``r`` of the
    stacked first-layer weights ``w0`` and of the projection stream."""
    cd, L = _kernel_setup("edge_project", v, v, w0)
    dev, n_nodes = v.device, v.shape[0]
    _check_tensor("v", v, (n_nodes, L), cd, dev)
    _check_tensor("w[0]", w0, (w0.shape[0], 3 * L, L), cd, dev)
    row = _stream_row(wstream, r, _stream_sizes(L, cd, 0, 0)[2], cd, dev)
    p, q = (torch.empty((n_nodes, L), dtype=torch.float32, device=dev) for _ in range(2))
    _project_launch(v, row, p, q)
    return p, q


def _project_launch(v, wstream, p, q) -> None:
    """K7's launch on inputs its caller has checked, into ``p`` and ``q``."""
    _kernel_init("fused_round", "mgn_edge_project_init", v.device.index)
    lib = _build.library("fused_round")
    rc = lib.mgn_edge_project(_DTYPE_CODES[v.dtype], v.shape[1], v.data_ptr(), p.data_ptr(),
                              q.data_ptr(), v.shape[0], wstream.data_ptr(),
                              torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(lib, rc, "edge_project")
    edge_project.launches += 1


def _edge_round_cuda(e, p, q, senders, receivers, edge_valid, mlp: List[torch.Tensor],
                     wstream, r: int, width: int) -> torch.Tensor:
    """``edge_round``'s CUDA implementation: K2 on round ``r`` of the
    stacked edge MLP (flat leaves ``mlp``) and of the edge stream, the
    LayerNorm over the real ``width``."""
    cd, L = _kernel_setup("edge_round", e, e, p, q, *mlp)
    dev, n_edges = e.device, e.shape[0]
    _check_rows("e", e, n_edges, cd, dev)
    for name, t in (("p", p), ("q", q)):
        _check_tensor(name, t, (p.shape[0], L), torch.float32, dev)
    for name, idx in (("senders", senders), ("receivers", receivers)):
        _check_rows(name, idx, n_edges, torch.int32, dev)
    _check_tensor("edge_valid", edge_valid, (n_edges, 1), cd, dev)
    params = _round_params(_packed(mlp, cd, dev, 3, L, width), r)
    row = _stream_row(wstream, r, _stream_sizes(L, cd, (len(mlp) - 2) // 2, 0)[0], cd, dev)
    msg = torch.empty_like(e)
    _kernel_init("fused_round", "mgn_edge_round_init", dev.index)
    lib = _build.library("fused_round")
    rc = lib.mgn_edge_round(
        _DTYPE_CODES[cd], L, e.data_ptr(), msg.data_ptr(), p.data_ptr(), q.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), edge_valid.data_ptr(), n_edges,
        ctypes.byref(params), row.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_round")
    edge_round.launches += 1
    return msg


def _node_round_cuda(v, agg, mlp: List[torch.Tensor], wstream, r: int, extra,
                     width: int) -> None:
    """``node_round``'s CUDA implementation: K3 on round ``r`` of the
    stacked node MLP (flat leaves ``mlp``) and of the node stream, the
    LayerNorm over the real ``width``."""
    cd, L = _kernel_setup("node_round", v, v, agg, extra, *mlp)
    dev, n_nodes = v.device, v.shape[0]
    _check_rows("v", v, n_nodes, cd, dev)
    _check_tensor("agg", agg, (n_nodes, L), torch.float32, dev)
    if extra is not None:
        _check_tensor("extra", extra, (n_nodes, L), torch.float32, dev)
    params = _round_params(_packed(mlp, cd, dev, 2, L, width), r)
    row = _stream_row(wstream, r, _stream_sizes(L, cd, 0, (len(mlp) - 2) // 2)[1], cd, dev)
    lib = _build.library("fused_round")
    rc = lib.mgn_node_round(_DTYPE_CODES[cd], L, v.data_ptr(), agg.data_ptr(),
                            None if extra is None else extra.data_ptr(), n_nodes,
                            ctypes.byref(params), row.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "node_round")
    if extra is None:
        node_round.launches += 1
    else:
        node_round.extra_launches += 1


def _new_saved(like: torch.Tensor, n_layers: int, rows_per_group: int) -> MlpSaved:
    rows, L = like.shape
    return MlpSaved([torch.empty_like(like) for _ in range(n_layers)],
                    [torch.empty_like(like) for _ in range(n_layers - 1)],
                    torch.empty((-(-rows // rows_per_group), 2 * L), dtype=torch.float32,
                                device=like.device))


def edge_round_bwd(de, dagg, e, p, q, senders, receivers, edge_valid, mlp, wstream,
                   defer: bool = False, width: Optional[int] = None):
    """K4: the reverse of one edge stage (see :func:`edge_round_bwd_plain`).
    Updates the carry ``de`` in place; returns ``(dvs, dvr, MlpSaved)``, or
    with ``defer`` (the ``defer_first`` form: the kernel stops after ``de``
    and writes no ``dvs``/``dvr``) the ``MlpSaved`` alone, whose ``dh[0]``
    is the first layer's cotangent ``dh0``.  ``e`` is the round's saved
    input, ``p``/``q`` :func:`edge_project`'s projections of its saved
    ``v`` (the forward's bits), ``dagg`` K5's f32 output, ``mlp`` as for
    :func:`edge_round`, ``wstream`` the round's row of the edge stream
    :func:`weight_streams` made with ``adjoint`` (the forward's; with
    ``defer``, made with ``defer`` too, or the same leading part of a full
    row); ``width`` as for :func:`edge_round`.  CPU: the plain version,
    which reads no ``wstream`` (None will do).  CUDA: counted in
    ``edge_round_bwd.launches``, or with ``defer`` in
    ``edge_round_bwd.defer_launches``."""
    if de.device.type == "cpu":
        new_de, *out = edge_round_bwd_plain(de, dagg, e, p, q, senders, receivers, edge_valid,
                                            mlp, defer, width)
        de.copy_(new_de)
        return out[0] if defer else tuple(out)
    cd, L = _kernel_setup("edge_round_bwd", de, *_mlp_tensors(mlp))
    dev, n_edges = de.device, de.shape[0]
    for name, t in (("de", de), ("e", e)):
        _check_tensor(name, t, (n_edges, L), cd, dev)
    n_nodes = p.shape[0]
    for name, t in (("p", p), ("q", q), ("dagg", dagg)):
        _check_tensor(name, t, (n_nodes, L), torch.float32, dev)
    for name, idx in (("senders", senders), ("receivers", receivers)):
        _check_rows(name, idx, n_edges, torch.int32, dev)
    _check_tensor("edge_valid", edge_valid, (n_edges, 1), cd, dev)
    params = _round_struct(mlp, cd, dev, 3, L, width)
    _check_tensor("wstream", wstream, (_stream_sizes(L, cd, len(mlp["w"]), 0, True, defer)[0],),
                  cd, dev)
    saved = _new_saved(de, len(mlp["w"]), _EDGE_BWD_ROWS)
    bwd = _bwd_struct(saved)
    dvs, dvr = (None, None) if defer else (torch.empty_like(de), torch.empty_like(de))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library("fused_round_bwd")
    rc = lib.mgn_edge_round_bwd(
        _DTYPE_CODES[cd], L, de.data_ptr(), ptr(dvs), ptr(dvr), dagg.data_ptr(),
        e.data_ptr(), p.data_ptr(), q.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        edge_valid.data_ptr(), n_edges, ctypes.byref(params), ctypes.byref(bwd),
        wstream.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_round_bwd")
    if defer:
        edge_round_bwd.defer_launches += 1
        return saved
    edge_round_bwd.launches += 1
    return dvs, dvr, saved


def node_round_bwd(dv, v, agg, mlp, wstream, extra=None, width: Optional[int] = None):
    """K5: the reverse of one node stage (see :func:`node_round_bwd_plain`).
    Updates the carry ``dv`` in place; returns ``(dagg (f32), MlpSaved)``,
    and with ``extra`` (the round's f32 ``(N, L)`` first-layer offset) a
    third output, the f32 ``dxtr``.  ``v``/``agg`` are the round's saved
    inputs in the compute dtype, ``mlp`` as for :func:`node_round`,
    ``wstream`` the round's row of the node stream :func:`weight_streams`
    made with ``adjoint`` (the forward's); ``width`` as for
    :func:`edge_round`.  CPU: the plain version, which reads no ``wstream``
    (None will do).  CUDA: counted in ``node_round_bwd.launches``, or with
    ``extra`` in ``node_round_bwd.extra_launches``."""
    if dv.device.type == "cpu":
        new_dv, *out = node_round_bwd_plain(dv, v, agg, mlp, extra, width)
        dv.copy_(new_dv)
        return tuple(out)
    cd, L = _kernel_setup("node_round_bwd", dv, extra, *_mlp_tensors(mlp))
    dev, n_nodes = dv.device, dv.shape[0]
    for name, t in (("dv", dv), ("v", v), ("agg", agg)):
        _check_tensor(name, t, (n_nodes, L), cd, dev)
    dxtr = None
    if extra is not None:
        _check_tensor("extra", extra, (n_nodes, L), torch.float32, dev)
        dxtr = torch.empty((n_nodes, L), dtype=torch.float32, device=dev)
    params = _round_struct(mlp, cd, dev, 2, L, width)
    _check_tensor("wstream", wstream, (_stream_sizes(L, cd, 0, len(mlp["w"]), True)[1],), cd,
                  dev)
    saved = _new_saved(dv, len(mlp["w"]), _NODE_BWD_ROWS)
    bwd = _bwd_struct(saved)
    dagg = torch.empty((n_nodes, L), dtype=torch.float32, device=dev)
    lib = _build.library("fused_round_bwd")
    rc = lib.mgn_node_round_bwd(
        _DTYPE_CODES[cd], L, dv.data_ptr(), dagg.data_ptr(), v.data_ptr(), agg.data_ptr(),
        None if extra is None else extra.data_ptr(), None if dxtr is None else dxtr.data_ptr(),
        n_nodes, ctypes.byref(params), ctypes.byref(bwd), wstream.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "node_round_bwd")
    if extra is None:
        node_round_bwd.launches += 1
        return dagg, saved
    node_round_bwd.extra_launches += 1
    return dagg, saved, dxtr


@functools.lru_cache(maxsize=None)
def _kernel_init(library: str, symbol: str, index: int) -> None:
    """A kernel's shared-memory attributes on device ``index`` (K2's
    ``mgn_edge_round_init``, K7's ``mgn_edge_project_init``, K8's
    ``mgn_first_layer_adjoint_init``), set once there, not before every
    launch; a failure is raised and not cached."""
    lib = _build.library(library)
    with torch.cuda.device(index):
        _build.check(lib, getattr(lib, symbol)(), symbol)


def first_layer_adjoint(dv, g_s, g_r, mlp, wstream) -> None:
    """K8: ``dv += rnd(G_s·W_sᵀ + G_r·W_rᵀ)`` in place, the end of a
    ``defer_first`` round (see :func:`first_layer_adjoint_plain`).  ``dv``
    is the carry (compute dtype), ``g_s``/``g_r`` the round's f32 ``(N,
    L)`` sums of ``dh0`` by sender and by receiver, ``mlp`` one round of the
    cast edge MLP, ``wstream`` the part past K7's of the round's row of
    :func:`weight_streams`' projection stream made with ``adjoint``.  Both
    products are f32 x f32 (bf16 weights are exact TF32 values), summed in
    f32 and rounded once.  CPU: the plain version, which reads no
    ``wstream`` (None will do).  CUDA: counted in
    ``first_layer_adjoint.launches``."""
    if dv.device.type == "cpu":
        dv.copy_(first_layer_adjoint_plain(dv, g_s, g_r, mlp))
        return
    cd, L = _kernel_setup("first_layer_adjoint", dv, mlp["w"][0])
    dev, n_nodes = dv.device, dv.shape[0]
    _check_tensor("dv", dv, (n_nodes, L), cd, dev)
    for name, t in (("g_s", g_s), ("g_r", g_r)):
        _check_tensor(name, t, (n_nodes, L), torch.float32, dev)
    _check_tensor("w[0]", mlp["w"][0], (3 * L, L), cd, dev)
    _check_tensor("wstream", wstream, (_stream_sizes(L, cd, 0, 0)[2],), cd, dev)
    _kernel_init("fused_round_bwd", "mgn_first_layer_adjoint_init", dev.index)
    lib = _build.library("fused_round_bwd")
    rc = lib.mgn_first_layer_adjoint(_DTYPE_CODES[cd], L, dv.data_ptr(), g_s.data_ptr(),
                                     g_r.data_ptr(), n_nodes, wstream.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "first_layer_adjoint")
    first_layer_adjoint.launches += 1


class WgradProduct(NamedTuple):
    """One product of a K6 group: ``dw = [x_p[idx_p]ᵀ @ dh for each part]``
    stacked on the input axis, and the column sums of ``dh`` split over
    ``db`` in order.  ``inputs`` empty: column sums only."""

    dh: torch.Tensor  # (rows, B)
    inputs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]] = ()  # (x, idx) per part
    dw: Optional[torch.Tensor] = None  # (parts * A, B) f32
    db: Sequence[torch.Tensor] = ()  # f32 vectors whose widths add up to B


class WgradPlan(NamedTuple):
    """How K6 lays a group out (``WgradTile`` and ``decode`` in
    ``csrc/wgrad.cu``): per product its output tiles a part, blocks a tile
    (``splits``, each a contiguous range of ``rows_per_block`` rows), first
    block in the grid, and, for tiles with several blocks, first counter
    pair and first float of their partial tiles in the scratch; the grid's
    blocks (``threads`` each, ``smem`` bytes of shared memory), the scratch
    floats and the counters a call uses."""

    products: List[Dict[str, int]]
    n_blocks: int
    n_scratch: int
    n_counters: int
    threads: int
    smem: int


def wgrad_tile(shapes: Sequence[Tuple[int, int, int, int]]) -> int:
    """K6's output tile side for a group of products ``(parts, rows, A,
    B)``: the largest of 128, 64 and 32 that divides every width, but 64
    where the group has fewer than ``_WGRAD_SMALL`` rows summed over its
    128-wide tiles — such a group (the ``N``-row pair alone) has too few
    chunks to fill the card with 128-wide tiles, and 64-wide ones run two
    blocks an SM (see PERF.md)."""
    dims = [d for parts, _, a_dim, b_dim in shapes for d in ((a_dim, b_dim) if parts else (b_dim,))]
    tile = next((t for t in (128, 64, 32) if all(d % t == 0 for d in dims)), None)
    if tile is None:
        raise ValueError(f"wgrad kernel takes widths that are multiples of 32, got {dims}")
    work = sum(max(parts, 1) * (a_dim // 128 if parts else 1) * (b_dim // 128) * rows
               for parts, rows, a_dim, b_dim in shapes) if tile == 128 else 0
    return 64 if tile == 128 and work < _WGRAD_SMALL else tile


def wgrad_plan(shapes: Sequence[Tuple[int, int, int, int]], tile: int, max_blocks: int,
               dtype: torch.dtype = torch.float32) -> WgradPlan:
    """The layout of a K6 group from each product's ``(parts, rows, A, B)``
    (``parts`` 0: column sums only), output tiles of ``tile`` x ``tile``,
    in one wave of ``max_blocks`` blocks (what the card holds at once: the
    launch is cooperative).  Each tile gets one block and a share of the
    other blocks in proportion to its rows — no more than give each block
    ``_WGRAD_MIN_CHUNKS`` chunks — each a contiguous whole-chunk range of
    its rows."""
    KC = _WGRAD_CHUNK
    consumers = 256 if tile == 128 else 128  # threads of the consumer warps
    slot = consumers * tile // 2 + tile  # floats of a partial tile: accumulators, bias
    tiles = [max(parts, 1) * (a_dim // tile if parts else 1) * (b_dim // tile)
             for parts, _, a_dim, b_dim in shapes]
    if sum(tiles) > max_blocks:
        raise ValueError(f"wgrad: a group of {sum(tiles)} output tiles, the card holds "
                         f"{max_blocks} blocks")
    total = sum(n * rows for n, (_, rows, _, _) in zip(tiles, shapes))
    out, block, counter, scratch = [], 0, 0, 0
    for n, (parts, rows, a_dim, b_dim) in zip(tiles, shapes):
        chunks = -(-rows // KC)
        cap = -(-chunks // _WGRAD_MIN_CHUNKS)
        want = min(cap, 1 + (max_blocks - sum(tiles)) * rows // total)
        per = -(-chunks // want) * KC
        splits = -(-rows // per)
        out.append(dict(parts=parts, rows=rows, a_dim=a_dim, b_dim=b_dim,
                        tiles_a=a_dim // tile if parts else 1, tiles_b=b_dim // tile,
                        splits=splits, rows_per_block=per, block0=block,
                        counter0=counter if splits > 1 else 0,
                        scratch0=scratch if splits > 1 else 0))
        block += n * splits
        if splits > 1:
            counter += 2 * n
            scratch += n * splits * slot
    threads = consumers + 128  # the producer warpgroup
    x_size = 4 if dtype == torch.float32 else 2
    smem = (128 + _WGRAD_STAGES * KC * ((tile + 8) * x_size + tile * 4)  # mbarriers, ring
            + 2 * 2 * KC * tile * 4 + threads * 4)  # planes, column sums
    return WgradPlan(out, block, scratch, counter, threads, smem)


@functools.lru_cache(maxsize=None)
def _wgrad_blocks(index: int, code: int, tile: int) -> int:
    """Blocks of K6 at (dtype code, tile) that device ``index`` holds at
    once, after setting its shared-memory attributes there."""
    _kernel_init("wgrad", "mgn_wgrad_init", index)
    lib = _build.library("wgrad")
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(lib, lib.mgn_wgrad_max_blocks(code, tile, ctypes.byref(n)),
                     "wgrad max blocks")
    if n.value < 1:
        raise RuntimeError(f"wgrad: device {index} holds no block of K6 at tile {tile}")
    return n.value


@functools.lru_cache(maxsize=None)
def _wgrad_counters(index: int) -> torch.Tensor:
    """K6's counters on device ``index``: zeroed once here, and left at 0
    by every launch (the last block of a tile resets the tile's pair)."""
    return torch.zeros((_WGRAD_COUNTERS,), dtype=torch.int32,
                       device=torch.device("cuda", index))


def _wgrad_product_plain(q: WgradProduct) -> None:
    if q.inputs:
        q.dw.copy_(torch.cat([wgrad_plain(q.dh, x, idx)[0] for x, idx in q.inputs]))
    col, off = wgrad_plain(q.dh)[1], 0
    for out in q.db:
        out.copy_(col[off: off + out.shape[0]])
        off += out.shape[0]


def _check_product(q: WgradProduct, cd: torch.dtype, device) -> Tuple[int, int, int, int]:
    rows, b_dim = q.dh.shape
    parts = len(q.inputs)
    # dh in the group's dtype, or f32 (the column sums; with x, the mixed form: the
    # defer_first first-layer rows, x exactly upcast and dh split as in the f32 route)
    _check_rows("dh", q.dh, rows, q.dh.dtype, device)
    if q.dh.dtype not in (cd, torch.float32):
        raise TypeError(f"wgrad: dh is {q.dh.dtype}, the group's dtype {cd}")
    if parts > 3 or (parts and q.dw is None):
        raise ValueError("wgrad: a product takes 1..3 parts and a dw to write")
    a_dim = q.inputs[0][0].shape[1] if parts else 0
    for x, idx in q.inputs:
        _check_rows("x", x, x.shape[0], cd, device)
        if x.shape[1] != a_dim:
            raise ValueError(f"wgrad: parts of widths {x.shape[1]} and {a_dim}")
        if idx is not None:
            _check_rows("idx", idx, rows, torch.int32, device)
        elif x.shape[0] != rows:
            raise ValueError(f"wgrad: x has {x.shape[0]} rows, dh {rows}")
    if parts:
        _check_tensor("dw", q.dw, (parts * a_dim, b_dim), torch.float32, device)
    if len(q.db) > 2 or (q.db and sum(d.shape[0] for d in q.db) != b_dim):
        raise ValueError(f"wgrad: at most 2 column-sum outputs, {b_dim} wide in all")
    for d in q.db:
        _check_tensor("db", d, (d.shape[0],), torch.float32, device)
    return parts, rows, a_dim, b_dim


def wgrad_group(products: Sequence[WgradProduct]) -> None:
    """K6: every product of ``products`` (one MLP round's weight, bias and
    LayerNorm gradients: :func:`mlp_wgrads`) in one launch that also adds
    the row splits, in a fixed order, so a gradient has the same bits from
    run to run.  Every ``x`` is in the group's compute dtype; ``dh`` is too,
    or f32 (bf16 groups: the mixed form).  CUDA: counted in
    ``wgrad.launches``, one per call; a launch the card refuses (its
    blocks not all resident at once, or its shared memory) raises."""
    if not products:
        raise ValueError("wgrad_group needs a product")
    dev = products[0].dh.device
    if dev.type == "cpu":
        for q in products:
            _wgrad_product_plain(q)
        return
    if dev.type != "cuda":
        raise ValueError(f"wgrad runs on cuda or cpu, not {dev}")
    if len(products) > _WGRAD_MAX_PRODUCTS:
        raise ValueError(f"wgrad takes at most {_WGRAD_MAX_PRODUCTS} products a launch")
    cd = next((q.inputs[0][0].dtype for q in products if q.inputs),
              next((q.dh.dtype for q in products if q.dh.dtype != torch.float32), torch.float32))
    if cd not in _DTYPE_CODES:
        raise TypeError(f"wgrad kernel takes f32 or bf16, got {cd}")
    shapes = [_check_product(q, cd, dev) for q in products]
    tile = wgrad_tile(shapes)
    index, code = dev.index or 0, _DTYPE_CODES[cd]
    plan = wgrad_plan(shapes, tile, _wgrad_blocks(index, code, tile), cd)
    counters = _wgrad_counters(index)
    if plan.n_counters > counters.numel():
        raise ValueError(f"wgrad: a group needs {plan.n_counters} counters")
    group = _build.WgradGroup()
    for g, q, p in zip(group.p, products, plan.products):
        for i, (x, idx) in enumerate(q.inputs):
            g.x[i] = x.data_ptr()
            g.idx[i] = None if idx is None else idx.data_ptr()
        g.dh = q.dh.data_ptr()
        g.dw = None if q.dw is None else q.dw.data_ptr()
        for i, d in enumerate(q.db):
            g.db[i] = d.data_ptr()
        g.b_split = q.db[0].shape[0] if q.db else p["b_dim"]
        g.dh_f32 = int(q.dh.dtype == torch.float32)
        for k, val in p.items():
            setattr(g, k, val)
    group.n_products, group.n_blocks = len(products), plan.n_blocks
    scratch = (torch.empty((plan.n_scratch,), dtype=torch.float32, device=dev)
               if plan.n_scratch else None)
    lib = _build.library("wgrad")
    rc = lib.mgn_wgrad_group(code, tile, ctypes.byref(group),
                             None if scratch is None else scratch.data_ptr(), plan.n_scratch,
                             counters.data_ptr(), counters.numel(),
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "wgrad")
    wgrad.launches += 1


def wgrad(dh, x=None, idx=None, dw=None, db=None) -> None:
    """K6 on one product: ``dw = x[idx]ᵀ @ dh`` and ``db = Σ_rows dh``, f32,
    written into the given outputs (either may be None; without ``dw`` only
    ``db`` is computed) — :func:`wgrad_group` with one product."""
    if dw is None and db is None:
        raise ValueError("wgrad needs dw or db to write")
    if dw is not None and x is None:
        raise ValueError("wgrad: dw needs x")
    wgrad_group([WgradProduct(dh, [(x, idx)] if dw is not None else [], dw,
                              [db] if db is not None else [])])


edge_project.launches = 0
edge_round.launches = 0
weight_streams.launches = 0
node_round.launches = 0
node_round.extra_launches = 0
edge_round_bwd.launches = 0
edge_round_bwd.defer_launches = 0
first_layer_adjoint.launches = 0
node_round_bwd.launches = 0
node_round_bwd.extra_launches = 0
wgrad.launches = 0


def cast_mlp(mlp: Dict[str, Any], cd: torch.dtype) -> Dict[str, Any]:
    """Weights and biases to the compute dtype (as ``apply_mlp_parts`` casts
    them), LayerNorm parameters f32: the form :func:`edge_round` and
    :func:`node_round` take their weights in."""
    return {"w": [w.to(cd).contiguous() for w in mlp["w"]],
            "b": [b.to(cd).contiguous() for b in mlp["b"]],
            "ln_scale": mlp["ln_scale"].float().contiguous(),
            "ln_bias": mlp["ln_bias"].float().contiguous()}


def mlp_wgrads(saved: MlpSaved, inputs, grads: Dict[str, Any], r: int,
               deferred: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()) -> None:
    """K6 over one MLP round, one :func:`wgrad_group` call: the first layer
    (``inputs``: one ``(x, idx)`` per part, all against ``dh_0``) with its
    bias, each hidden layer from the ReLU output feeding it, the LayerNorm
    gradients from the per-group partial sums, and for each ``(x, G)`` of
    ``deferred`` (the ``defer_first`` form's node-space sums) the first
    layer's next row block ``xᵀ·G`` (an ``N``-row product; ``G`` f32);
    written into round ``r`` of the f32 gradient stacks ``grads``."""
    gw, gb = grads["w"], grads["b"]
    w0 = gw[0][r]
    rows = [x.shape[1] for x, _ in inputs]
    products = [WgradProduct(saved.dh[0], list(inputs), w0[:sum(rows)], [gb[0][r]])]
    products += [WgradProduct(saved.dh[i], [(saved.post[i - 1], None)], gw[i][r], [gb[i][r]])
                 for i in range(1, len(saved.dh))]
    products.append(WgradProduct(saved.ln, (), None,
                                 [grads["ln_scale"][r], grads["ln_bias"][r]]))
    off = sum(rows)
    for x, g in deferred:
        products.append(WgradProduct(g, [(x, None)], w0[off: off + x.shape[1]]))
        off += x.shape[1]
    wgrad_group(products)


_MLPS = ("edge_mlp", "node_mlp")


def _flatten_proc(proc) -> List[torch.Tensor]:
    return [t for m in _MLPS for t in _mlp_tensors(proc[m])]


def _unflatten_proc(leaves: Sequence[torch.Tensor], n_layers: Tuple[int, int]):
    out, i = {}, 0
    for m, n in zip(_MLPS, n_layers):
        out[m] = {"w": list(leaves[i: i + n]), "b": list(leaves[i + n: i + 2 * n]),
                  "ln_scale": leaves[i + 2 * n], "ln_bias": leaves[i + 2 * n + 1]}
        i += 2 * n + 2
    return out


class _Graph(NamedTuple):
    senders: torch.Tensor
    receivers: torch.Tensor
    row_offsets: torch.Tensor
    sender_perm: Optional[torch.Tensor]
    sender_offsets: Optional[torch.Tensor]
    edge_valid: torch.Tensor


def _forward_rounds(em, nm, v0, e0, g: _Graph, mps: int, saves=None, node_extra=None,
                    defer: bool = False, width: Optional[int] = None):
    """The forward loop on copies of ``v0``/``e0``, through the operators
    (``torch.ops.mgn_tpu_torch``, :mod:`mgn_tpu_torch.ops.library`) on
    every device: one ``weight_streams``, then per round ``edge_project``
    (K7) -> ``edge_round`` (K2) -> ``csr_segment_sum`` (K1) ->
    ``node_round`` (K3), each on the stacked weights and the round's index
    (on CUDA the kernels, every round's parameters checked and packed at the
    first launch; on the CPU their plain versions, which read no stream).
    Nothing here reads a pointer, so the loop traces (``torch.export``).
    ``saves`` (three ``(mps, ·, L)`` stacks) receives each round's
    start-of-round ``v``, ``e`` and compute-dtype aggregate, copied before
    the round updates ``v`` and ``e`` in place; with it the streams also
    hold K4's (in the ``defer_first`` form's extent with ``defer``), K5's
    and K8's products.  ``node_extra(r, v)``, called at the start of round
    ``r``, returns K3's f32 ``(N, L)`` offset for the round.  ``width``:
    the model's width inside the tile ``L`` (None: ``L``), which K2's and
    K3's LayerNorm run over.
    Returns ``(v, e, (edge stream, node stream, projection stream))``."""
    ops = torch.ops.mgn_tpu_torch
    cd, n_pad = v0.dtype, v0.shape[0]
    width = v0.shape[-1] if width is None else width
    v = v0.to(cd, copy=True).contiguous()
    e = e0.to(cd, copy=True).contiguous()
    edge, node = _mlp_tensors(em), _mlp_tensors(nm)
    # every round's K7, K2 and K3 weights (and K4's, K5's, K8's for the backward), one launch
    streams = ws_e, ws_n, ws_p = ops.weight_streams(edge, node, saves is not None, defer)
    for r in range(mps):
        extra = None if node_extra is None else node_extra(r, v)
        if saves is not None:
            saves[0][r].copy_(v)
            saves[1][r].copy_(e)
        p, q = ops.edge_project(v, em["w"][0], ws_p, r)
        msg = ops.edge_round(e, p, q, g.senders, g.receivers, g.edge_valid, edge, ws_e, r,
                             width)
        agg = csr_segment_sum(msg, g.receivers, g.row_offsets, n_pad)
        if saves is not None:
            saves[2][r].copy_(agg)
        ops.node_round(v, agg, node, ws_n, r, extra, width)
    return v, e, streams


def _defer(n_edges: int, n_nodes: int) -> bool:
    """Whether the backward takes the ``defer_first`` form: where ``E >= N``,
    the JAX backward's rule (``mgn_tpu/ops/fused.py:1680-1683``) without its
    VMEM gate, or as ``_FORCE_DEFER`` pins it."""
    return bool(_FORCE_DEFER) if _FORCE_DEFER is not None else n_edges >= n_nodes


class _FusedProcess(torch.autograd.Function):
    """``fused_process`` with the backward kernels (P5/P6's math), the edge
    stage's adjoint in the ``defer_first`` form where :func:`_defer` says.
    ``extra`` (None, or with ``mps == 1`` the round's f32 first-layer
    offset) is an input like ``v0``: K5 recomputes with it and its gradient
    is K5's ``dxtr``."""

    @staticmethod
    def forward(ctx, g: _Graph, mps: int, n_layers, width: int, v0, e0, extra, *leaves):
        proc = _unflatten_proc(leaves, n_layers)
        cd = v0.dtype
        em, nm = cast_mlp(proc["edge_mlp"], cd), cast_mlp(proc["node_mlp"], cd)
        n, e_rows, L = v0.shape[0], e0.shape[0], v0.shape[1]
        saves = (v0.new_empty((mps, n, L)), v0.new_empty((mps, e_rows, L)),
                 v0.new_empty((mps, n, L)))
        ctx.defer = _defer(e_rows, n)  # the backward's form, and so the edge stream's
        v, e, streams = _forward_rounds(em, nm, v0, e0, g, mps, saves,
                                        None if extra is None else lambda r, v: extra,
                                        ctx.defer, width)
        ctx.save_for_backward(*saves, *streams, extra, *leaves)
        ctx.g, ctx.mps, ctx.n_layers, ctx.e_dtype = g, mps, n_layers, e0.dtype
        ctx.width = width
        ctx.set_materialize_grads(False)
        return v, e

    @staticmethod
    def backward(ctx, gv, ge):
        vsave, esave, aggsave, ws_e, ws_n, ws_p, extra, *leaves = ctx.saved_tensors
        g, mps, width = ctx.g, ctx.mps, ctx.width
        proc = _unflatten_proc(leaves, ctx.n_layers)
        cd, n_pad = vsave.dtype, vsave.shape[1]
        em, nm = cast_mlp(proc["edge_mlp"], cd), cast_mlp(proc["node_mlp"], cd)
        dv = (torch.zeros_like(vsave[0]) if gv is None
              else gv.to(cd, copy=True).contiguous())
        de = (torch.zeros_like(esave[0]) if ge is None
              else ge.to(cd, copy=True).contiguous())
        grads = _unflatten_proc([torch.zeros_like(t) for t in leaves], ctx.n_layers)
        defer = ctx.defer
        p_size = _stream_sizes(vsave.shape[2], cd, 0, 0)[2]
        row = lambda ws, r, part: None if ws is None else ws[r][part]
        if defer:  # G_s, G_r: dh0 summed by sender and by receiver, reused every round
            g_s, g_r = vsave.new_empty((2, n_pad, vsave.shape[2]), dtype=torch.float32)
        dxtr = None
        for r in reversed(range(mps)):
            v_r, e_r, agg_r = vsave[r], esave[r], aggsave[r]
            dagg, saved_n, *dx = node_round_bwd(dv, v_r, agg_r, round_params(nm, r),
                                                row(ws_n, r, slice(None)), extra, width)
            if dx:
                dxtr = dx[0]
            mlp_wgrads(saved_n, [(v_r, None), (agg_r, None)], grads["node_mlp"], r)
            # the pre-projected recompute: K7 on the saved v, the forward's P and Q bits
            em_r = round_params(em, r)
            p, q = edge_project(v_r, em_r, row(ws_p, r, slice(p_size)))
            bwd = (de, dagg, e_r, p, q, g.senders, g.receivers, g.edge_valid, em_r,
                   row(ws_e, r, slice(None)))
            if defer:
                saved_e = edge_round_bwd(*bwd, defer=True, width=width)
                dh0 = saved_e.dh[0]
                csr_segment_sum(dh0, g.receivers, g.row_offsets, n_pad, out=g_r)
                csr_segment_sum(dh0, g.senders, g.sender_offsets, n_pad, perm=g.sender_perm,
                                out=g_s)
                first_layer_adjoint(dv, g_s, g_r, em_r, row(ws_p, r, slice(p_size, None)))
                mlp_wgrads(saved_e, [(e_r, None)], grads["edge_mlp"], r,
                           deferred=[(v_r, g_s), (v_r, g_r)])
            else:
                dvs, dvr, saved_e = edge_round_bwd(*bwd, width=width)
                by_receiver = csr_segment_sum(dvr, g.receivers, g.row_offsets, n_pad)
                by_sender = csr_segment_sum(dvs, g.senders, g.sender_offsets, n_pad,
                                            perm=g.sender_perm)
                dv += (by_receiver + by_sender).to(cd)
                mlp_wgrads(saved_e, [(e_r, None), (v_r, g.senders), (v_r, g.receivers)],
                           grads["edge_mlp"], r)
        return (None, None, None, None, dv, de.to(ctx.e_dtype), dxtr, *_flatten_proc(grads))


def kernel_width(L: int, device: Union[str, torch.device, None] = "cuda") -> int:
    """The tile width a processor of latent width ``L`` runs at: the
    narrowest of the widths the kernels are built for (32, 64, 128, 256)
    that holds ``L``.  :func:`fused_process` pads a processor of any other
    width to it.  Above 256 a CUDA ``device`` raises (the edge tile stages
    64 rows of the whole width: a wider one needs another row count, ROADMAP
    A8.2); the CPU's plain versions take any width, so there it is ``L``."""
    if L < 1:
        raise ValueError(f"a latent width must be at least 1, got {L}")
    tile = next((k for k in _KERNEL_LATENTS if k >= L), None)
    if tile is not None:
        return tile
    if torch.device(device).type == "cuda":
        raise ValueError(f"latent width {L}: the kernels run widths up to "
                         f"{_KERNEL_LATENTS[-1]}; wider ones need the edge tile at another row "
                         "count (ROADMAP A8.2)")
    return L


def _pad_cols(x: torch.Tensor, tile: int) -> torch.Tensor:
    """``x`` with zero columns appended up to ``tile`` (differentiable: the
    gradient is the slice back)."""
    return torch.nn.functional.pad(x, (0, tile - x.shape[-1]))


def _pad_mlp(mlp: Dict[str, Any], L: int, tile: int) -> Dict[str, Any]:
    """A processor MLP stacked on ``(mps,)`` at width ``L``, padded to
    ``tile`` with zeros: each ``L``-row block of the first layer's weight
    (three for the edge MLP, two for the node MLP) to its own ``tile``-row
    block, every other weight, bias and LayerNorm parameter to ``tile``
    rows and columns.  Every padded column of the MLP's output is then 0."""
    w0 = mlp["w"][0]
    rounds, parts = w0.shape[0], w0.shape[1] // L
    if parts * L != w0.shape[1]:
        raise ValueError(f"first-layer weight of {w0.shape[1]} rows at width {L}")
    grow = (0, tile - L, 0, tile - L)
    w0 = torch.nn.functional.pad(w0.reshape(rounds, parts, L, L), grow)
    return {"w": [w0.reshape(rounds, parts * tile, tile)]
            + [torch.nn.functional.pad(w, grow) for w in mlp["w"][1:]],
            "b": [_pad_cols(b, tile) for b in mlp["b"]],
            "ln_scale": _pad_cols(mlp["ln_scale"], tile),
            "ln_bias": _pad_cols(mlp["ln_bias"], tile)}


def fused_process(proc_params, v0, e0, senders, receivers, row_offsets, edge_valid,
                  mps: int, return_edges: bool = False,
                  sender_perm: Optional[torch.Tensor] = None,
                  sender_offsets: Optional[torch.Tensor] = None,
                  node_extra: Union[None, torch.Tensor,
                                    Callable[[int, torch.Tensor], torch.Tensor]] = None):
    """Run ``mps`` processor rounds; the compute dtype is ``v0.dtype``.

    ``proc_params`` is the stacked processor dict (``init_mgn``);
    ``edge_valid`` is ``(E_pad, 1)`` in the compute dtype.  One launch lays
    out both MLPs' weights for K7, K2 and K3, and for K4 and K5 where a
    gradient is needed (:func:`weight_streams`), then per round K7 -> K2 ->
    K1 -> K3 on copies of ``v0``/``e0`` (their plain versions on the CPU;
    :func:`process_rounds_plain` with ``preproject=True`` gives the same
    bits there).  Where autograd needs a gradient (of the parameters, ``v0``,
    ``e0`` or a tensor ``node_extra``) the rounds run as a
    ``torch.autograd.Function`` whose backward is, per round, K5/K6/K7/K4,
    then K1 on both sides, K8 and K6 (``defer_first``, where ``E >= N``) or
    K1 on both sides and K6, and needs ``sender_perm``/``sender_offsets``,
    the template's sender-side CSR (``GraphTemplate``).

    ``node_extra`` (the cloth family) is the f32 ``(N_pad, L)`` offset that
    K3 adds into the node MLP's first-layer pre-activation, in one of two
    forms:
    - a tensor, with ``mps == 1`` (it is a per-round quantity), as the JAX
      package's ``fused_process(node_extra=)`` takes it; differentiable: its
      gradient is K5's ``dxtr``;
    - a callable ``node_extra(r, v)``, called at the start of round ``r``
      with the round's ``v`` (updated in place later in the round: use it,
      do not keep it), returning the round's offset: one weight-stream
      launch still lays out every round.  Forward only: where a gradient is
      needed it raises ``NotImplementedError``.

    A latent width ``L`` the kernels are not built for runs at
    :func:`kernel_width` ``(L)``, on both devices: the parameters, ``v0``,
    ``e0`` and ``node_extra`` are padded with zeros at the call
    (differentiable, so autograd slices their gradients back), every padded
    column stays 0 through the rounds, the LayerNorm runs over the real
    ``L`` columns, and ``v`` and ``e`` come back sliced to ``L``.  A built
    width runs as it is, with no pad.
    Returns ``v`` (and ``e`` with ``return_edges``).
    """
    if v0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_process runs on cuda or cpu, not {v0.device}")
    width = v0.shape[-1]
    tile = kernel_width(width, v0.device)
    if tile != width:
        proc_params = {m: _pad_mlp(proc_params[m], width, tile) for m in _MLPS}
        v0, e0 = _pad_cols(v0, tile), _pad_cols(e0, tile)
        if isinstance(node_extra, torch.Tensor):
            node_extra = _pad_cols(node_extra, tile)
        elif node_extra is not None:
            real_hook = node_extra
            node_extra = lambda r, v: _pad_cols(real_hook(r, v[:, :width]), tile)  # noqa: E731
    leaves = _flatten_proc(proc_params)
    n_layers = (len(proc_params["edge_mlp"]["w"]), len(proc_params["node_mlp"]["w"]))
    extra = node_extra if isinstance(node_extra, torch.Tensor) else None
    if extra is not None and int(mps) != 1:
        raise ValueError("a node_extra tensor is a per-round quantity: call fused_process "
                         "with mps=1 per round (apply_mgn_multi does where it trains)")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (v0, e0, extra, *leaves))
    if needs_grad and node_extra is not None and extra is None:
        raise NotImplementedError(
            "fused_process with a node_extra hook is forward only (one weight-stream launch "
            "for every round); for a gradient pass node_extra as a tensor, one mps=1 call a "
            "round, or run the forward under torch.no_grad()")
    if needs_grad:
        if sender_perm is None or sender_offsets is None:
            raise ValueError("a gradient through fused_process needs the sender-side CSR: "
                             "pass the template's sender_perm and sender_offsets")
        g = _Graph(senders, receivers, row_offsets, sender_perm, sender_offsets, edge_valid)
        v, e = _FusedProcess.apply(g, int(mps), n_layers, width, v0, e0, extra, *leaves)
    else:
        cd = v0.dtype
        g = _Graph(senders, receivers, row_offsets, None, None, edge_valid)
        hook = node_extra if extra is None else (lambda r, v: extra)
        v, e, _ = _forward_rounds(cast_mlp(proc_params["edge_mlp"], cd),
                                  cast_mlp(proc_params["node_mlp"], cd), v0, e0, g, int(mps),
                                  node_extra=hook, width=width)
    if tile != width:
        v, e = v[:, :width].contiguous(), e[:, :width].contiguous()
    return (v, e) if return_edges else v
