"""Port: ``odeint_tsit5_adaptive`` (adaptive Tsit5 with the PI controller)
against ``mgn_tpu.rollout.integrators.odeint_tsit5_adaptive`` on the CPU:
the same right-hand side, rtol/atol and save grids as
tests/test_integrators.py's adaptive cases, the same outputs and the same
number of tries per save interval.

The JAX function's tries are counted by running it op by op
(``jax.disable_jit``: its ``while_loop`` becomes a Python loop that calls
``f`` seven times a try, stage 0 at the try's start time), and its jitted
outputs are held against that run too.  The right-hand sides give the same
bits in both packages (``cos`` through numpy in f64, rounded to f32): the
error estimate is a near-cancelling f32 sum, so one ulp of ``f`` moves a
step size and, a few tries later, an accept decision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.rollout.integrators import odeint_tsit5_adaptive as jax_adaptive
from mgn_tpu_torch.rollout.evaluate import make_rollout_fn
from mgn_tpu_torch.rollout.integrators import odeint_tsit5_adaptive


def _cos_jax(y, t):
    return jnp.full(y.shape, np.float32(np.cos(np.float64(np.asarray(t)))))


def _cos_torch(y, t):
    return torch.full(y.shape, float(np.float32(np.cos(np.float64(t.item())))))


CASES = {  # tests/test_integrators.py: stiffish (:50), nonautonomous (:60), non-uniform (:96)
    "stiffish": (lambda y, t: -50.0 * y, lambda y, t: -50.0 * y, np.ones(2, np.float32),
                 np.linspace(0, 0.5, 6, dtype=np.float32), dict(rtol=1e-6, atol=1e-8, dt0=0.1)),
    "nonautonomous": (_cos_jax, _cos_torch, np.zeros(1, np.float32),
                      np.linspace(0, 3, 7, dtype=np.float32), dict(rtol=1e-7, atol=1e-9)),
    "nonuniform": (_cos_jax, _cos_torch, np.zeros(1, np.float32),
                   np.asarray([0.0, 0.01, 0.03, 0.5, 3.0, 5.5], np.float32),
                   dict(rtol=1e-7, atol=1e-9)),
    "nonuniform-dense": (_cos_jax, _cos_torch, np.zeros(1, np.float32),
                         np.linspace(0.0, 5.5, 551, dtype=np.float32), dict(rtol=1e-7, atol=1e-9)),
}


def _jax_tries(fj, y0, saveat, kw):
    """The JAX function op by op: its output and its tries per interval."""
    starts = []

    def f(y, t):
        starts.append(float(t))
        return fj(y, t)

    with jax.disable_jit():
        out = jax_adaptive(f, jnp.asarray(y0), jnp.asarray(saveat), **kw)
    tries = np.bincount(np.searchsorted(saveat, starts[::7], side="right") - 1,
                        minlength=len(saveat) - 1)
    return np.asarray(out), tries.tolist()


@pytest.mark.parametrize("name", list(CASES))
def test_adaptive_tsit5_matches_jax_with_the_same_tries(name):
    fj, ft, y0, saveat, kw = CASES[name]
    ref, tries = _jax_tries(fj, y0, saveat, kw)
    stats = []
    out = odeint_tsit5_adaptive(ft, torch.from_numpy(y0), torch.from_numpy(saveat),
                                stats=stats, **kw)
    assert out.dtype == torch.float32 and out.shape == (len(saveat), *y0.shape)
    assert [a + r for a, r in stats] == tries
    assert all(a >= 1 for a, _ in stats)  # every interval reached its save point
    np.testing.assert_array_equal(out.numpy(), ref)
    if name != "nonuniform-dense":  # the jitted JAX function: the same within 1e-6
        fj_jit = (lambda y, t: -50.0 * y) if name == "stiffish" else (
            lambda y, t: jnp.cos(t) * jnp.ones_like(y))
        jit = np.asarray(jax_adaptive(fj_jit, jnp.asarray(y0), jnp.asarray(saveat), **kw))
        np.testing.assert_allclose(out.numpy(), jit, rtol=1e-6, atol=1e-6)


def test_adaptive_tsit5_is_accurate_and_carries_dt_across_intervals():
    """The analytic solutions of the stiffish and non-autonomous cases
    (tests/test_integrators.py's accuracy bounds), and a later interval
    starting from the step size the previous one ended with: its first try
    is not the interval's width."""
    f = lambda y, t: -50.0 * y
    saveat = torch.linspace(0, 0.5, 6)
    stats = []
    out = odeint_tsit5_adaptive(f, torch.ones(2), saveat, rtol=1e-6, atol=1e-8, dt0=0.1,
                                stats=stats)
    np.testing.assert_allclose(out[:, 0].numpy(), np.exp(-50 * saveat.numpy()), atol=1e-5)
    assert sum(a for a, _ in stats) > 5 * len(stats)  # the stiff decay needs many steps
    g = lambda y, t: torch.cos(t) * torch.ones_like(y)
    saveat = torch.linspace(0, 3, 7)
    out = odeint_tsit5_adaptive(g, torch.zeros(1), saveat, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(out[:, 0].numpy(), np.sin(saveat.numpy()), atol=1e-5)


def test_adaptive_tsit5_stops_after_max_steps_and_refuses_axis_name():
    """At max_steps_per_interval tries an interval ends where it stands, as
    the JAX while_loop does; axis_name waits for the graph-parallel port."""
    f = lambda y, t: -50.0 * y
    stats = []
    out = odeint_tsit5_adaptive(f, torch.ones(2), torch.linspace(0, 0.5, 3), rtol=1e-6,
                                atol=1e-8, dt0=0.1, max_steps_per_interval=3, stats=stats)
    assert all(a + r == 3 for a, r in stats)
    assert out.shape == (3, 2) and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="A7"):
        odeint_tsit5_adaptive(f, torch.ones(2), torch.linspace(0, 1, 3), axis_name="graph")


def test_make_rollout_fn_takes_the_adaptive_solver():
    """make_rollout_fn builds the adaptive rollout (it raised before) and
    still refuses an unknown solver."""
    from mgn_tpu_torch.models.mgn import MGNConfig
    from mgn_tpu_torch.train.common import FieldSpec
    cfg = MGNConfig(node_input_dim=11, edge_input_dim=3, output_dim=2)
    spec = FieldSpec(("velocity",), ("velocity",), (2,), (2,))
    assert callable(make_rollout_fn(cfg, spec, solver="tsit5_adaptive"))
    with pytest.raises(ValueError, match="tsit5_adaptive"):
        make_rollout_fn(cfg, spec, solver="rk45")
