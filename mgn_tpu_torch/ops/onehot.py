"""K9 ``window_gather`` and K10 ``onehot_pair``, with their plain versions.

The counterparts of the JAX package's two TPU probes of the fused kernel's
gathers (``csrc/onehot_probe.cu`` says what each kernel does on the card):

- K9 (``benchmarks/probe_dyngather_tpu.py:main.make``) sums ``rounds``
  passes of ``chunks`` row gathers from banded windows of ``v``:
  ``out (chunk, L) f32 = sum_r sum_c f32(v[starts[c] + rel[c, i]])``, rounds
  outer, chunks inner, from zero.  Its two variants, ``onehot`` (a one-hot
  tensor-core product over the window) and ``direct`` (row reads), compute
  the same function and give the same bits.
- K10 (``benchmarks/probe_onehot_dtype_tpu.py:main``) sums ``rounds`` rounds
  of a one-hot gather and a one-hot scatter:
  ``out (band, L) f32 = sum_t (cast(band)[rel_t[:band]] + scatter_t)`` with
  ``rel_t = (rel + t) mod band`` and ``scatter_t[b] = sum over rel_t[i] = b of
  cast(msg)[i]``; ``cast`` is the value type, ``"bf16"`` (round to nearest
  even), ``"f32"`` or ``"int8"`` (toward zero).

Their indices are checked once, on the host, when :func:`make_window` or
:func:`make_pair_inputs` builds them, so that a launch makes no host sync.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (counted in ``window_gather.launches`` and
``onehot_pair.launches``) or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mgn_tpu_torch.ops import _build

__all__ = ["WINDOW_VARIANTS", "PAIR_VALUES", "Window", "PairInputs", "make_window",
           "make_pair_inputs", "window_gather", "window_gather_plain", "onehot_pair",
           "onehot_pair_plain"]

WINDOW_VARIANTS = ("onehot", "direct")
PAIR_VALUES = ("bf16", "f32", "int8")  # the value types, in the kernel's route order

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass(frozen=True)
class Window:
    """K9's checked gather indices on one device: ``rel (C, chunk)`` and
    ``starts (C,)`` int32, ``0 <= rel < band``; ``rows`` is the least number
    of rows ``v`` must have, ``max(starts) + max(band, chunk)`` (the TPU
    probe's ``direct`` variant reads a window of ``chunk`` rows)."""

    rel: torch.Tensor
    starts: torch.Tensor
    band: int
    rows: int


def make_window(rel, starts, band: int, device) -> Window:
    """Check ``rel`` and ``starts`` (numpy arrays or tensors) on the host and
    put them on ``device``; raises ``ValueError`` where K9 would read outside
    a window."""
    rel, starts = _host(rel), _host(starts)
    if rel.ndim != 2 or starts.shape != (rel.shape[0],) or rel.size == 0:
        raise ValueError(f"rel must be (C, chunk) and starts (C,), got {rel.shape} and "
                         f"{starts.shape}")
    if not (np.issubdtype(rel.dtype, np.integer) and np.issubdtype(starts.dtype, np.integer)):
        raise ValueError(f"rel and starts must be integers, got {rel.dtype}, {starts.dtype}")
    if band <= 0 or rel.min() < 0 or rel.max() >= band:
        raise ValueError(f"window_gather needs 0 <= rel < band = {band}, got rel in "
                         f"[{rel.min()}, {rel.max()}]")
    if starts.min() < 0:
        raise ValueError(f"window_gather needs starts >= 0, got {starts.min()}")
    return Window(rel=torch.as_tensor(rel.astype(np.int32)).to(device).contiguous(),
                  starts=torch.as_tensor(starts.astype(np.int32)).to(device).contiguous(),
                  band=int(band), rows=int(starts.max()) + max(int(band), rel.shape[1]))


def window_gather_plain(v: torch.Tensor, win: Window, rounds: int) -> torch.Tensor:
    """Plain version: ``rounds`` x ``C`` row gathers added in f32, in K9's
    order."""
    rows = (win.starts[:, None].long() + win.rel.long())
    out = torch.zeros((win.rel.shape[1], v.shape[1]), dtype=torch.float32, device=v.device)
    for _ in range(rounds):
        for c in range(rows.shape[0]):
            out += v.index_select(0, rows[c]).float()
    return out


def _launch_window(v: torch.Tensor, win: Window, rounds: int, variant: str) -> torch.Tensor:
    if v.dtype not in _DTYPE_CODES:
        raise TypeError(f"window_gather kernel takes f32 or bf16 v, got {v.dtype}")
    n_chunks, chunk = win.rel.shape
    L = v.shape[1]
    if not v.is_contiguous() or v.data_ptr() % 16 or (L * v.element_size()) % 16:
        raise ValueError("window_gather kernel takes a contiguous, 16-byte aligned v whose "
                         f"rows are a multiple of 16 bytes, got {tuple(v.shape)} {v.dtype}")
    if variant == "onehot" and (win.band % 64 or L % 16
                                or rounds * n_chunks * (win.band // 64) >= 2 ** 31):
        raise ValueError(f"the onehot variant needs band % 64 == 0, L % 16 == 0 and fewer than "
                         f"2^31 slices, got band {win.band}, L {L}, {rounds} x {n_chunks} chunks")
    out = torch.empty((chunk, L), dtype=torch.float32, device=v.device)
    lib = _build.library("onehot_probe")
    rc = lib.mgn_window_gather(
        _DTYPE_CODES[v.dtype], WINDOW_VARIANTS.index(variant), v.data_ptr(),
        win.rel.data_ptr(), win.starts.data_ptr(), out.data_ptr(), L, chunk, win.band,
        n_chunks, rounds, torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(lib, rc, "window_gather")
    window_gather.launches += 1
    return out


def window_gather(v: torch.Tensor, win: Window, rounds: int,
                  variant: str = "onehot") -> torch.Tensor:
    """K9: ``rounds`` passes of ``C`` gathers of ``chunk`` rows from ``v (N,
    L)`` (f32 or bf16), summed into f32 ``(chunk, L)``.  ``variant``:
    ``"onehot"`` or ``"direct"``; both give the same values.  CUDA tensors:
    the kernel; CPU tensors: :func:`window_gather_plain`."""
    if variant not in WINDOW_VARIANTS:
        raise ValueError(f"variant must be one of {WINDOW_VARIANTS}, got {variant!r}")
    if rounds <= 0 or v.dim() != 2 or v.shape[0] < win.rows:
        raise ValueError(f"window_gather needs rounds > 0 and v (N >= {win.rows}, L), got "
                         f"rounds {rounds}, v {tuple(v.shape)}")
    if win.rel.device != v.device:
        raise ValueError(f"the window lies on {win.rel.device}, v on {v.device}")
    if v.device.type == "cpu":
        return window_gather_plain(v, win, rounds)
    if v.device.type != "cuda":
        raise ValueError(f"window_gather runs on cuda or cpu, not {v.device}")
    return _launch_window(v, win, rounds, variant)


window_gather.launches = 0


@dataclass(frozen=True)
class PairInputs:
    """K10's checked inputs on one device: ``rel (chunk,)`` int32 with ``0 <=
    rel < band``, ``band (band, L)`` and ``msg (chunk, L)`` f32, ``band <=
    chunk``; ``int8_exact`` says that every value of ``band`` and ``msg``
    truncates into int8's range, so the ``"int8"`` cast is defined."""

    rel: torch.Tensor
    band: torch.Tensor
    msg: torch.Tensor
    int8_exact: bool


def make_pair_inputs(rel, band, msg, device) -> PairInputs:
    """Check K10's inputs (numpy arrays or tensors) on the host and put them
    on ``device``; raises ``ValueError`` where they do not fit."""
    rel, band, msg = _host(rel), _host(band).astype(np.float32), _host(msg).astype(np.float32)
    if rel.ndim != 1 or band.ndim != 2 or msg.shape != (rel.shape[0], band.shape[1]):
        raise ValueError(f"onehot_pair needs rel (chunk,), band (band, L), msg (chunk, L); got "
                         f"{rel.shape}, {band.shape}, {msg.shape}")
    if not np.issubdtype(rel.dtype, np.integer):
        raise ValueError(f"rel must be integers, got {rel.dtype}")
    n_band = band.shape[0]
    if not 0 < n_band <= rel.shape[0] or rel.min() < 0 or rel.max() >= n_band:
        raise ValueError(f"onehot_pair needs 0 < band <= chunk and 0 <= rel < band = {n_band}; "
                         f"got chunk {rel.shape[0]}, rel in [{rel.min()}, {rel.max()}]")
    int8_exact = bool(all(((x > -129) & (x < 128)).all() for x in (band, msg)))
    return PairInputs(rel=torch.as_tensor(rel.astype(np.int32)).to(device).contiguous(),
                      band=torch.as_tensor(band).to(device).contiguous(),
                      msg=torch.as_tensor(msg).to(device).contiguous(), int8_exact=int8_exact)


def _cast(x: torch.Tensor, value: str) -> torch.Tensor:
    if value == "bf16":
        return x.to(torch.bfloat16).float()
    if value == "int8":
        return x.to(torch.int8).float()
    return x


def onehot_pair_plain(inputs: PairInputs, rounds: int, value: str) -> torch.Tensor:
    """Plain version: per round a row gather and an f32 ``index_add_``."""
    band, msg = _cast(inputs.band, value), _cast(inputs.msg, value)
    n_band = band.shape[0]
    rel = inputs.rel.long()
    out = torch.zeros_like(band)
    for t in range(rounds):
        rel_t = (rel + t) % n_band
        out += band.index_select(0, rel_t[:n_band]) + torch.zeros_like(band).index_add_(
            0, rel_t, msg)
    return out


def onehot_pair(inputs: PairInputs, rounds: int, value: str) -> torch.Tensor:
    """K10: ``rounds`` rounds of the one-hot gather and scatter with values
    cast to ``value`` (one of :data:`PAIR_VALUES`), summed into f32 ``(band,
    L)``.  CUDA tensors: the kernel, one launch for every round; CPU
    tensors: :func:`onehot_pair_plain`."""
    if value not in PAIR_VALUES:
        raise ValueError(f"value must be one of {PAIR_VALUES}, got {value!r}")
    if rounds <= 0:
        raise ValueError(f"onehot_pair needs rounds > 0, got {rounds}")
    if value == "int8" and not inputs.int8_exact:
        raise ValueError("a value of band or msg lies outside int8's range")
    device = inputs.band.device
    if device.type == "cpu":
        return onehot_pair_plain(inputs, rounds, value)
    if device.type != "cuda":
        raise ValueError(f"onehot_pair runs on cuda or cpu, not {device}")
    n_band, L = inputs.band.shape
    chunk = inputs.rel.shape[0]
    cols = 8 if value == "f32" else 16  # the kernel's columns a block
    if n_band % 32 or chunk % 32 or L % cols:
        raise ValueError(f"the onehot_pair kernel needs band and chunk multiples of 32 and L of "
                         f"{cols}; got band {n_band}, chunk {chunk}, L {L}")
    out = torch.empty((n_band, L), dtype=torch.float32, device=device)
    lib = _build.library("onehot_probe")
    rc = lib.mgn_onehot_pair(PAIR_VALUES.index(value), inputs.rel.data_ptr(),
                             inputs.band.data_ptr(), inputs.msg.data_ptr(), out.data_ptr(), L,
                             n_band, chunk, rounds, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, rc, "onehot_pair")
    onehot_pair.launches += 1
    return out


onehot_pair.launches = 0
