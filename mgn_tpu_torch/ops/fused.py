"""The processor rounds, forward and backward: kernels K2 (edge stage), K3
(node stage), K4 (edge stage backward), K5 (node stage backward) and K6
(weight gradients), their plain PyTorch versions, and the round loops.

The counterpart of ``mgn_tpu/ops/fused.py``: :func:`fused_process` runs the
``mps`` message-passing rounds that the TPU kernel ``_make_kernel`` runs in
one VMEM-resident call, as a host loop of three launches per round —
K2 ``edge_round`` -> K1 ``csr_segment_sum`` -> K3 ``node_round``
(``csrc/fused_round.cu``, ``csrc/csr_segment.cu``).  Where a gradient is
needed it runs as a ``torch.autograd.Function`` (the JAX ``custom_vjp``):
the forward saves each round's start-of-round ``v``, ``e`` and the
compute-dtype aggregate in ``(mps, ·, L)`` residual stacks (what the TPU
forward saves with ``save_residuals``), and the backward walks the rounds in
reverse as ``_make_bwd_kernel`` does — per round K5 ``node_round_bwd``, one
grouped K6 ``wgrad`` call for the node MLP, K4 ``edge_round_bwd``, K1 over
the receivers and K1 over the senders (through the template's sender
permutation), one K6 call for the edge MLP (``csrc/fused_round_bwd.cu``,
``csrc/wgrad.cu``).  K4 and K6 run on the tensor cores (bf16 directly, f32
through 3xTF32; ``csrc/mma_tile.cuh``).  The banding plan,
VMEM budgeting and one-hot gathers of the TPU kernels have no counterpart: a
GPU gathers rows directly and keeps the state in device memory.

Dtype rules (``mgn_tpu/ops/fused.py:_mlp_bwd``): cotangent carries in the
compute dtype, weight, bias and LayerNorm gradients in f32, LayerNorm
statistics in f32; biases rounded to the compute dtype as in
``apply_mlp_parts``.

:func:`process_rounds_plain` is the plain reference, the counterpart of
``process_rounds_xla``: the same round math from plain PyTorch ops on any
device, differentiated by ``torch.autograd``.  Each kernel wrapper launches
its kernel for CUDA tensors and runs its plain version for CPU tensors; any
other device raises.  So on the CPU :func:`fused_process` runs the same loops
and the same ``Function`` through the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from mgn_tpu_torch.models.mlp import _dot, apply_mlp_parts
from mgn_tpu_torch.ops import _build
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_plain
from mgn_tpu_torch.ops.segment import gather

__all__ = ["edge_round", "edge_round_plain", "node_round", "node_round_plain",
           "edge_round_bwd", "edge_round_bwd_plain", "node_round_bwd",
           "node_round_bwd_plain", "wgrad", "wgrad_group", "wgrad_plain",
           "wgrad_plan", "wgrad_splits", "WgradProduct", "WgradPlan", "MlpSaved",
           "fused_process", "process_rounds_plain", "round_params", "cast_mlp",
           "transpose_mlp", "mlp_wgrads"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_LATENTS = (32, 64, 128, 256)  # the widths csrc/fused_round*.cu are built for
# rows per group of the LayerNorm partial sums K4/K5 write: one 64-edge tile
# of K4 (EdgeBwd::kRows in csrc/fused_round_bwd.cu), one 2-row warp of K5
# (kNodeRows)
_EDGE_BWD_ROWS = 64
_NODE_BWD_ROWS = 2
_WGRAD_CHUNK = 32  # rows per ring stage of K6 (kChunk in csrc/wgrad.cu)
_WGRAD_MIN_CHUNKS = 4  # a K6 row split spans at least this many chunks where rows allow
_WGRAD_MAX_PRODUCTS = 10  # products per K6 launch (kWgradMaxProducts)


class MlpSaved(NamedTuple):
    """What K4/K5 (or their plain versions) hand to K6 for one MLP round."""

    dh: List[torch.Tensor]  # per layer: (rows, L) pre-activation cotangent, compute dtype
    post: List[torch.Tensor]  # per hidden layer: (rows, L) ReLU output, compute dtype
    ln: torch.Tensor  # (groups, 2L) f32: [sum dy*xhat | sum dy] per group of rows


# --- plain versions -----------------------------------------------------------

def edge_round_plain(e, v, senders, receivers, edge_valid,
                     mlp) -> Tuple[torch.Tensor, torch.Tensor]:
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


def _mlp_recompute(mlp, parts: Sequence[torch.Tensor], cd):
    """``apply_mlp_parts``' forward, keeping what its adjoint needs: the
    ReLU outputs (compute dtype) and the LayerNorm's ``xhat`` and ``rstd``
    (f32)."""
    w, b = mlp["w"], mlp["b"]
    h, off = None, 0
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
    mean = h32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((h32 - mean).square().mean(dim=-1, keepdim=True) + 1e-5)
    return posts, (h32 - mean) * rstd, rstd


def _mlp_adjoint(mlp, dy, posts, xhat, rstd, cd, n_parts: int):
    """The adjoint of ``apply_mlp_parts`` from the f32 cotangent ``dy`` of
    its LayerNorm output, as ``mgn_tpu/ops/fused.py:_mlp_bwd`` computes it.
    Returns (per-part input cotangents, per-layer pre-activation cotangents),
    all in the compute dtype."""
    w = mlp["w"]
    L = xhat.shape[-1]
    dxhat = dy * mlp["ln_scale"].float()
    dh = ((dxhat - dxhat.mean(dim=-1, keepdim=True)
           - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True)) * rstd).to(cd)
    dhs = [dh] * len(w)
    for i in range(len(w) - 1, 0, -1):
        dh = _dot(dh, w[i].t(), cd).to(cd) * (posts[i - 1] > 0).to(cd)
        dhs[i - 1] = dh
    dparts = [_dot(dh, w[0][p * L: (p + 1) * L].t(), cd).to(cd) for p in range(n_parts)]
    return dparts, dhs


def _ln_partials(dy, xhat, rows_per_group: int) -> torch.Tensor:
    """``[dy * xhat | dy]`` summed over consecutive groups of rows: the
    layout of the per-warp partial sums K4/K5 write."""
    g = torch.cat([dy * xhat, dy], dim=-1)
    pad = -g.shape[0] % rows_per_group
    if pad:
        g = torch.cat([g, g.new_zeros((pad, g.shape[1]))])
    return g.view(-1, rows_per_group, g.shape[1]).sum(dim=1)


def edge_round_bwd_plain(de, dagg, e, v, senders, receivers, edge_valid, mlp):
    """Plain K4, the reverse of one edge stage at the round's saved ``e``
    and ``v``: ``dmsg = (de + dagg[receivers]) * edge_valid`` through the
    recomputed edge MLP.  Returns ``(de + de_part, dvs, dvr, MlpSaved)``."""
    cd = e.dtype
    posts, xhat, rstd = _mlp_recompute(mlp, (e, gather(v, senders), gather(v, receivers)), cd)
    dmsg = (de + gather(dagg, receivers).to(cd)) * edge_valid
    dy = dmsg.float()
    (de_p, dvs, dvr), dhs = _mlp_adjoint(mlp, dy, posts, xhat, rstd, cd, 3)
    return de + de_p, dvs, dvr, MlpSaved(dhs, posts, _ln_partials(dy, xhat, _EDGE_BWD_ROWS))


def node_round_bwd_plain(dv, v, agg, mlp):
    """Plain K5, the reverse of one node stage at the round's saved ``v`` and
    compute-dtype ``agg``: the update's cotangent is ``dv``.  Returns
    ``(dv + dv_part, dagg (f32), MlpSaved)``."""
    cd = v.dtype
    posts, xhat, rstd = _mlp_recompute(mlp, (v, agg), cd)
    dy = dv.float()
    (dv_p, dagg), dhs = _mlp_adjoint(mlp, dy, posts, xhat, rstd, cd, 2)
    return dv + dv_p, dagg.float(), MlpSaved(dhs, posts, _ln_partials(dy, xhat, _NODE_BWD_ROWS))


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
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {dtype} "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _mlp_struct(mlp: Dict[str, Any], cd: torch.dtype, device, parts: int,
                L: int) -> _build.MlpParams:
    """Check one round's weights and pack their pointers for the kernel."""
    n = len(mlp["w"])
    if not 1 <= n <= 8 or len(mlp["b"]) != n:
        raise ValueError(f"kernel MLPs take 1..8 layers, got {n}")
    shapes = [(parts * L, L)] + [(L, L)] * (n - 1)
    for i, (w, shape) in enumerate(zip(mlp["w"], shapes)):
        _check_tensor(f"w[{i}]", w, shape, cd, device)
    for i, b in enumerate(mlp["b"]):
        _check_tensor(f"b[{i}]", b, (L,), cd, device)
    for name in ("ln_scale", "ln_bias"):
        _check_tensor(name, mlp[name], (L,), torch.float32, device)
    p = _build.MlpParams()
    for i in range(n):
        p.w[i] = mlp["w"][i].data_ptr()
        p.b[i] = mlp["b"][i].data_ptr()
    p.ln_scale = mlp["ln_scale"].data_ptr()
    p.ln_bias = mlp["ln_bias"].data_ptr()
    p.n_layers = n
    return p


def _bwd_struct(wt: Sequence[torch.Tensor], saved: MlpSaved, cd: torch.dtype, device,
                parts: int, L: int) -> _build.BwdParams:
    """Check one round's transposed weights and pack them with the output
    buffers of K4/K5."""
    q = _build.BwdParams()
    shapes = [(L, parts * L)] + [(L, L)] * (len(wt) - 1)
    for i, (w, shape) in enumerate(zip(wt, shapes)):
        _check_tensor(f"wt[{i}]", w, shape, cd, device)
        q.wt[i] = w.data_ptr()
        q.dh[i] = saved.dh[i].data_ptr()
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
    through :func:`fused_process`'s ``Function``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes f32 or bf16, got {x.dtype}")
    if x.shape[-1] not in _KERNEL_LATENTS:
        raise ValueError(f"{name} kernel is built for latents {_KERNEL_LATENTS}, "
                         f"got {x.shape[-1]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError(f"{name} is not differentiable on its own: call fused_process, "
                           "whose autograd Function runs the backward kernels")
    return x.dtype, x.shape[-1]


def _mlp_tensors(mlp) -> List[torch.Tensor]:
    return [*mlp["w"], *mlp["b"], mlp["ln_scale"], mlp["ln_bias"]]


def edge_round(e, v, senders, receivers, edge_valid, mlp) -> torch.Tensor:
    """K2: one edge stage.  Updates ``e`` in place (``e += msg``) and returns
    ``msg``.  ``mlp`` is one round of the edge MLP with weights and biases
    already in the compute dtype (``e.dtype``) and f32 LayerNorm parameters.
    CUDA: counted in ``edge_round.launches``."""
    if e.device.type == "cpu":
        new_e, msg = edge_round_plain(e, v, senders, receivers, edge_valid, mlp)
        e.copy_(new_e)
        return msg
    cd, L = _kernel_setup("edge_round", e, e, v, *_mlp_tensors(mlp))
    dev, n_edges = e.device, e.shape[0]
    _check_rows("e", e, n_edges, cd, dev)
    _check_tensor("v", v, (v.shape[0], L), cd, dev)
    for name, idx in (("senders", senders), ("receivers", receivers)):
        _check_rows(name, idx, n_edges, torch.int32, dev)
    _check_tensor("edge_valid", edge_valid, (n_edges, 1), cd, dev)
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
    cd, L = _kernel_setup("node_round", v, v, agg, *_mlp_tensors(mlp))
    dev, n_nodes = v.device, v.shape[0]
    _check_rows("v", v, n_nodes, cd, dev)
    _check_tensor("agg", agg, (n_nodes, L), torch.float32, dev)
    params = _mlp_struct(mlp, cd, dev, parts=2, L=L)
    lib = _build.library("fused_round")
    rc = lib.mgn_node_round(_DTYPE_CODES[cd], L, v.data_ptr(), agg.data_ptr(), n_nodes,
                            ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "node_round")
    node_round.launches += 1


def _new_saved(like: torch.Tensor, n_layers: int, rows_per_group: int) -> MlpSaved:
    rows, L = like.shape
    return MlpSaved([torch.empty_like(like) for _ in range(n_layers)],
                    [torch.empty_like(like) for _ in range(n_layers - 1)],
                    torch.empty((-(-rows // rows_per_group), 2 * L), dtype=torch.float32,
                                device=like.device))


def edge_round_bwd(de, dagg, e, v, senders, receivers, edge_valid, mlp,
                   mlp_t: Optional[Sequence[torch.Tensor]] = None):
    """K4: the reverse of one edge stage (see :func:`edge_round_bwd_plain`).
    Updates the carry ``de`` in place; returns ``(dvs, dvr, MlpSaved)``.
    ``e``/``v`` are the round's saved inputs, ``dagg`` K5's f32 output, ``mlp``
    as for :func:`edge_round`, ``mlp_t`` its weights transposed
    (:func:`transpose_mlp`; computed here when absent).  CUDA: counted in
    ``edge_round_bwd.launches``; in f32 the call first splits the round's
    weights for 3xTF32 into a scratch buffer (a second, small launch)."""
    if de.device.type == "cpu":
        new_de, dvs, dvr, saved = edge_round_bwd_plain(de, dagg, e, v, senders, receivers,
                                                       edge_valid, mlp)
        de.copy_(new_de)
        return dvs, dvr, saved
    cd, L = _kernel_setup("edge_round_bwd", de, *_mlp_tensors(mlp))
    dev, n_edges = de.device, de.shape[0]
    for name, t in (("de", de), ("e", e)):
        _check_tensor(name, t, (n_edges, L), cd, dev)
    n_nodes = v.shape[0]
    _check_tensor("v", v, (n_nodes, L), cd, dev)
    _check_tensor("dagg", dagg, (n_nodes, L), torch.float32, dev)
    for name, idx in (("senders", senders), ("receivers", receivers)):
        _check_rows(name, idx, n_edges, torch.int32, dev)
    _check_tensor("edge_valid", edge_valid, (n_edges, 1), cd, dev)
    params = _mlp_struct(mlp, cd, dev, parts=3, L=L)
    if mlp_t is None:
        mlp_t = [w.t().contiguous() for w in mlp["w"]]
    saved = _new_saved(de, len(mlp["w"]), _EDGE_BWD_ROWS)
    bwd = _bwd_struct(mlp_t, saved, cd, dev, parts=3, L=L)
    if cd == torch.float32:  # scratch of the weight stream split for 3xTF32
        wsplit = torch.empty((2 * (4 + 2 * len(mlp["w"])) * L * L,), dtype=cd, device=dev)
        bwd.wsplit = wsplit.data_ptr()
    dvs, dvr = torch.empty_like(de), torch.empty_like(de)
    lib = _build.library("fused_round_bwd")
    rc = lib.mgn_edge_round_bwd(
        _DTYPE_CODES[cd], L, de.data_ptr(), dvs.data_ptr(), dvr.data_ptr(), dagg.data_ptr(),
        e.data_ptr(), v.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        edge_valid.data_ptr(), n_edges, ctypes.byref(params), ctypes.byref(bwd),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_round_bwd")
    edge_round_bwd.launches += 1
    return dvs, dvr, saved


def node_round_bwd(dv, v, agg, mlp, mlp_t: Optional[Sequence[torch.Tensor]] = None):
    """K5: the reverse of one node stage (see :func:`node_round_bwd_plain`).
    Updates the carry ``dv`` in place; returns ``(dagg (f32), MlpSaved)``.
    ``v``/``agg`` are the round's saved inputs in the compute dtype.  CUDA:
    counted in ``node_round_bwd.launches``."""
    if dv.device.type == "cpu":
        new_dv, dagg, saved = node_round_bwd_plain(dv, v, agg, mlp)
        dv.copy_(new_dv)
        return dagg, saved
    cd, L = _kernel_setup("node_round_bwd", dv, *_mlp_tensors(mlp))
    dev, n_nodes = dv.device, dv.shape[0]
    for name, t in (("dv", dv), ("v", v), ("agg", agg)):
        _check_tensor(name, t, (n_nodes, L), cd, dev)
    params = _mlp_struct(mlp, cd, dev, parts=2, L=L)
    if mlp_t is None:
        mlp_t = [w.t().contiguous() for w in mlp["w"]]
    saved = _new_saved(dv, len(mlp["w"]), _NODE_BWD_ROWS)
    bwd = _bwd_struct(mlp_t, saved, cd, dev, parts=2, L=L)
    dagg = torch.empty((n_nodes, L), dtype=torch.float32, device=dev)
    lib = _build.library("fused_round_bwd")
    rc = lib.mgn_node_round_bwd(
        _DTYPE_CODES[cd], L, dv.data_ptr(), dagg.data_ptr(), v.data_ptr(), agg.data_ptr(),
        n_nodes, ctypes.byref(params), ctypes.byref(bwd),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "node_round_bwd")
    node_round_bwd.launches += 1
    return dagg, saved


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class WgradProduct(NamedTuple):
    """One product of a K6 group: ``dw = [x_p[idx_p]ᵀ @ dh for each part]``
    stacked on the input axis, and the column sums of ``dh`` split over
    ``db`` in order.  ``inputs`` empty: column sums only."""

    dh: torch.Tensor  # (rows, B)
    inputs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]] = ()  # (x, idx) per part
    dw: Optional[torch.Tensor] = None  # (parts * A, B) f32
    db: Sequence[torch.Tensor] = ()  # f32 vectors whose widths add up to B


class WgradPlan(NamedTuple):
    """How K6 lays a group out: per product its tiles, row splits, first
    block in pass 1's grid, first float of its partial sums in the scratch
    and first output in pass 2's numbering."""

    products: List[Dict[str, int]]
    n_jobs: int
    n_out: int
    n_scratch: int


def wgrad_splits(rows: int, tiles: int, sm_count: int) -> Tuple[int, int]:
    """``(splits, rows_per_split)`` of one product: about two blocks per SM
    over its output tiles, each split a whole number of ring chunks and at
    least ``_WGRAD_MIN_CHUNKS`` of them where the rows allow."""
    chunks = -(-rows // _WGRAD_CHUNK)
    splits = max(1, min(-(-2 * sm_count // tiles), -(-chunks // _WGRAD_MIN_CHUNKS)))
    per = -(-chunks // splits) * _WGRAD_CHUNK
    return -(-rows // per), per


def wgrad_plan(shapes: Sequence[Tuple[int, int, int, int]], tile: int,
               sm_count: int) -> WgradPlan:
    """The layout of a K6 group from each product's ``(parts, rows, A, B)``
    (``parts`` 0: column sums only), output tiles of ``tile`` x ``tile``."""
    out, job, scratch, n_out = [], 0, 0, 0
    for parts, rows, a_dim, b_dim in shapes:
        tiles_a, tiles_b = (a_dim // tile if parts else 1), b_dim // tile
        tiles = max(parts, 1) * tiles_a * tiles_b
        splits, per = wgrad_splits(rows, tiles, sm_count)
        width = parts * a_dim * b_dim + b_dim  # products, then column sums
        out.append(dict(parts=parts, rows=rows, a_dim=a_dim, b_dim=b_dim, tiles_a=tiles_a,
                        tiles_b=tiles_b, splits=splits, rows_per_split=per, job0=job,
                        scratch0=scratch, out0=n_out))
        job += tiles * splits
        scratch += splits * width
        n_out += width
    return WgradPlan(out, job, n_out, scratch)


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
    _check_rows("dh", q.dh, rows, cd if parts else q.dh.dtype, device)
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
    LayerNorm gradients: :func:`mlp_wgrads`) in one grouped launch and one
    launch that adds the row splits in a fixed order, so a gradient has the
    same bits from run to run.  CUDA: counted in ``wgrad.launches``, one per
    call."""
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
    cd = next((q.dh.dtype for q in products if q.inputs or q.dh.dtype != torch.float32),
              torch.float32)
    if cd not in _DTYPE_CODES:
        raise TypeError(f"wgrad kernel takes f32 or bf16, got {cd}")
    shapes = [_check_product(q, cd, dev) for q in products]
    dims = [d for s in shapes for d in (s[2], s[3]) if d]
    tile = 64 if all(d % 64 == 0 for d in dims) else 32
    if any(d % 32 for d in dims):
        raise ValueError(f"wgrad kernel takes widths that are multiples of 32, got {dims}")
    plan = wgrad_plan(shapes, tile, _sm_count(dev.index or 0))
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
    group.n_products, group.n_jobs, group.n_out = len(products), plan.n_jobs, plan.n_out
    scratch = torch.empty((plan.n_scratch,), dtype=torch.float32, device=dev)
    lib = _build.library("wgrad")
    rc = lib.mgn_wgrad_group(_DTYPE_CODES[cd], tile, ctypes.byref(group), scratch.data_ptr(),
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


edge_round.launches = 0
node_round.launches = 0
edge_round_bwd.launches = 0
node_round_bwd.launches = 0
wgrad.launches = 0


def cast_mlp(mlp: Dict[str, Any], cd: torch.dtype) -> Dict[str, Any]:
    """Weights and biases to the compute dtype (as ``apply_mlp_parts`` casts
    them), LayerNorm parameters f32: the form :func:`edge_round` and
    :func:`node_round` take their weights in."""
    return {"w": [w.to(cd).contiguous() for w in mlp["w"]],
            "b": [b.to(cd).contiguous() for b in mlp["b"]],
            "ln_scale": mlp["ln_scale"].float().contiguous(),
            "ln_bias": mlp["ln_bias"].float().contiguous()}


def transpose_mlp(mlp: Dict[str, Any]) -> List[torch.Tensor]:
    """The (stacked) weights of a cast MLP transposed to ``(L, in)``, once per
    backward: K4/K5 run their adjoint products through the forward's matmul
    routine on them."""
    return [w.transpose(-1, -2).contiguous() for w in mlp["w"]]


def mlp_wgrads(saved: MlpSaved, inputs, grads: Dict[str, Any], r: int) -> None:
    """K6 over one MLP round, one :func:`wgrad_group` call: the first layer
    (``inputs``: one ``(x, idx)`` per part, all against ``dh_0``) with its
    bias, each hidden layer from the ReLU output feeding it, and the
    LayerNorm gradients from the per-group partial sums; written into round
    ``r`` of the f32 gradient stacks ``grads``."""
    gw, gb = grads["w"], grads["b"]
    products = [WgradProduct(saved.dh[0], list(inputs), gw[0][r], [gb[0][r]])]
    products += [WgradProduct(saved.dh[i], [(saved.post[i - 1], None)], gw[i][r], [gb[i][r]])
                 for i in range(1, len(saved.dh))]
    products.append(WgradProduct(saved.ln, (), None,
                                 [grads["ln_scale"][r], grads["ln_bias"][r]]))
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


def _forward_rounds(em, nm, v0, e0, g: _Graph, mps: int, saves=None):
    """The forward loop on copies of ``v0``/``e0``; ``saves`` (three
    ``(mps, ·, L)`` stacks) receives each round's start-of-round ``v``, ``e``
    and compute-dtype aggregate, copied before the round updates ``v`` and
    ``e`` in place."""
    cd, n_pad = v0.dtype, v0.shape[0]
    v = v0.to(cd, copy=True).contiguous()
    e = e0.to(cd, copy=True).contiguous()
    for r in range(mps):
        if saves is not None:
            saves[0][r].copy_(v)
            saves[1][r].copy_(e)
        msg = edge_round(e, v, g.senders, g.receivers, g.edge_valid, round_params(em, r))
        agg = csr_segment_sum(msg, g.receivers, g.row_offsets, n_pad)
        if saves is not None:
            saves[2][r].copy_(agg)
        node_round(v, agg, round_params(nm, r))
    return v, e


class _FusedProcess(torch.autograd.Function):
    """``fused_process`` with the backward kernels (P5/P6's math)."""

    @staticmethod
    def forward(ctx, g: _Graph, mps: int, n_layers, v0, e0, *leaves):
        proc = _unflatten_proc(leaves, n_layers)
        cd = v0.dtype
        em, nm = cast_mlp(proc["edge_mlp"], cd), cast_mlp(proc["node_mlp"], cd)
        n, e_rows, L = v0.shape[0], e0.shape[0], v0.shape[1]
        saves = (v0.new_empty((mps, n, L)), v0.new_empty((mps, e_rows, L)),
                 v0.new_empty((mps, n, L)))
        v, e = _forward_rounds(em, nm, v0, e0, g, mps, saves)
        ctx.save_for_backward(*saves, *leaves)
        ctx.g, ctx.mps, ctx.n_layers, ctx.e_dtype = g, mps, n_layers, e0.dtype
        ctx.set_materialize_grads(False)
        return v, e

    @staticmethod
    def backward(ctx, gv, ge):
        vsave, esave, aggsave, *leaves = ctx.saved_tensors
        g, mps = ctx.g, ctx.mps
        proc = _unflatten_proc(leaves, ctx.n_layers)
        cd, n_pad = vsave.dtype, vsave.shape[1]
        em, nm = cast_mlp(proc["edge_mlp"], cd), cast_mlp(proc["node_mlp"], cd)
        emt, nmt = transpose_mlp(em), transpose_mlp(nm)
        dv = (torch.zeros_like(vsave[0]) if gv is None
              else gv.to(cd, copy=True).contiguous())
        de = (torch.zeros_like(esave[0]) if ge is None
              else ge.to(cd, copy=True).contiguous())
        grads = _unflatten_proc([torch.zeros_like(t) for t in leaves], ctx.n_layers)
        for r in reversed(range(mps)):
            v_r, e_r, agg_r = vsave[r], esave[r], aggsave[r]
            dagg, saved_n = node_round_bwd(dv, v_r, agg_r, round_params(nm, r),
                                           [w[r] for w in nmt])
            mlp_wgrads(saved_n, [(v_r, None), (agg_r, None)], grads["node_mlp"], r)
            dvs, dvr, saved_e = edge_round_bwd(de, dagg, e_r, v_r, g.senders, g.receivers,
                                               g.edge_valid, round_params(em, r),
                                               [w[r] for w in emt])
            by_receiver = csr_segment_sum(dvr, g.receivers, g.row_offsets, n_pad)
            by_sender = csr_segment_sum(dvs, g.senders, g.sender_offsets, n_pad,
                                        perm=g.sender_perm)
            dv += (by_receiver + by_sender).to(cd)
            mlp_wgrads(saved_e, [(e_r, None), (v_r, g.senders), (v_r, g.receivers)],
                       grads["edge_mlp"], r)
        return (None, None, None, dv, de.to(ctx.e_dtype), *_flatten_proc(grads))


def fused_process(proc_params, v0, e0, senders, receivers, row_offsets, edge_valid,
                  mps: int, return_edges: bool = False,
                  sender_perm: Optional[torch.Tensor] = None,
                  sender_offsets: Optional[torch.Tensor] = None):
    """Run ``mps`` processor rounds; the compute dtype is ``v0.dtype``.

    ``proc_params`` is the stacked processor dict (``init_mgn``);
    ``edge_valid`` is ``(E_pad, 1)`` in the compute dtype.  Per round
    K2 -> K1 -> K3 on copies of ``v0``/``e0`` (their plain versions on the
    CPU).  Where autograd needs a gradient (of the parameters, ``v0`` or
    ``e0``) the rounds run as a ``torch.autograd.Function`` whose backward
    is K5/K6/K4/K1 per round and needs ``sender_perm``/``sender_offsets``,
    the template's sender-side CSR (``GraphTemplate``).
    Returns ``v`` (and ``e`` with ``return_edges``).
    """
    if v0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_process runs on cuda or cpu, not {v0.device}")
    leaves = _flatten_proc(proc_params)
    n_layers = (len(proc_params["edge_mlp"]["w"]), len(proc_params["node_mlp"]["w"]))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (v0, e0, *leaves)):
        if sender_perm is None or sender_offsets is None:
            raise ValueError("a gradient through fused_process needs the sender-side CSR: "
                             "pass the template's sender_perm and sender_offsets")
        g = _Graph(senders, receivers, row_offsets, sender_perm, sender_offsets, edge_valid)
        v, e = _FusedProcess.apply(g, int(mps), n_layers, v0, e0, *leaves)
    else:
        cd = v0.dtype
        g = _Graph(senders, receivers, row_offsets, None, None, edge_valid)
        v, e = _forward_rounds(cast_mlp(proc_params["edge_mlp"], cd),
                               cast_mlp(proc_params["node_mlp"], cd), v0, e0, g, int(mps))
    return (v, e) if return_edges else v
