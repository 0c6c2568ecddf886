"""Port: ``utils/indexing`` against ``mgn_tpu.utils.indexing``, and
``utils/profiling`` (``trace``, ``timed``, ``edges_per_sec``,
``debug_mode``) on the CPU, ``trace``'s guarded GPU route with its profile
stood in for."""

import json
import os

import numpy as np
import pytest
import torch

from mgn_tpu.utils import indexing as JI
from mgn_tpu.utils.profiling import edges_per_sec as jax_edges_per_sec
from mgn_tpu_torch.utils import indexing as TI
from mgn_tpu_torch.utils.profiling import debug_mode, edges_per_sec, timed, trace


@pytest.mark.parametrize("dims", [(7,), (3, 4), (2, 5, 3), (4, 1, 6, 2)])
def test_indexing_matches_jax(dims):
    """Every linear index of the grid to its cartesian index and back, as
    the JAX package's helpers give them (column-major, 0-based)."""
    for li in range(int(np.prod(dims))):
        ci = TI.li_to_ci(dims, li)
        assert ci == JI.li_to_ci(dims, li)
        assert np.ravel_multi_index(ci, dims, order="F") == li
        assert TI.ci_to_li(dims, ci) == JI.ci_to_li(dims, ci) == TI.dims_to_li(dims, ci) == li
    bad = tuple(d for d in dims)  # one past the end in every axis
    for mod in (TI, JI):
        with pytest.raises(IndexError):
            mod.ci_to_li(dims, bad)


def test_timed_and_edges_per_sec():
    calls = []
    secs = timed(lambda x: calls.append(x) or torch.ones(3) * x, 2.0, iters=4, warmup=3)
    assert len(calls) == 7 and secs > 0.0
    assert edges_per_sec(11042, 15, 0.002) == jax_edges_per_sec(11042, 15, 0.002)
    assert edges_per_sec(11042, 15, 0.002) == 11042 * 15 / 0.002
    assert edges_per_sec(10, 1, 0.0) == jax_edges_per_sec(10, 1, 0.0)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "tr")) as prof:
        (a @ a).sum()
    assert any("matmul" in e.key or "mm" in e.key for e in prof.key_averages())
    with open(os.path.join(tmp_path, "tr", "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("intact", [True, False])
def test_trace_warns_where_a_guard_is_lost(tmp_path, monkeypatch, intact):
    """Where a GPU is present ``trace`` profiles through ``guarded_profile``
    and exports its profile; one that lost a guard warns.  The guarded
    profile is stood in for by a CPU profile here."""
    import contextlib
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from mgn_tpu_torch.utils import profiling

    @contextlib.contextmanager
    def fake_guarded():
        g = profiling.GuardedProfile()
        with profile(activities=[ProfilerActivity.CPU]) as g.prof:
            yield g
        g.intact = intact

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "guarded_profile", fake_guarded)
    a = torch.randn(16, 16)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with trace(str(tmp_path / "tr")):
            (a @ a).sum()
    lost = [w for w in caught if "lost device events" in str(w.message)]
    assert len(lost) == (0 if intact else 1)
    assert os.path.exists(os.path.join(tmp_path, "tr", "trace.json"))


def test_debug_mode_raises_on_a_nan_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    before = torch.is_anomaly_enabled()
    with debug_mode(nans=True, disable_jit=True):
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert torch.is_anomaly_enabled() == before
    torch.sqrt(x).sum().backward()  # outside: no check


def test_profiler_drift_probe_needs_a_gpu():
    """The probe measures the card's profiler; without CUDA it refuses."""
    from mgn_tpu_torch.probes import profiler_drift
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probe runs there")
    with pytest.raises(SystemExit, match="CUDA"):
        profiler_drift.main(["--minutes", "0"])
