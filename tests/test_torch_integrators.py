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
from mgn_tpu.rollout.integrators import odeint_tsit5_bounded as jax_bounded
from mgn_tpu_torch.rollout.evaluate import make_rollout_fn
from mgn_tpu_torch.rollout.integrators import (odeint_fixed, odeint_tsit5_adaptive,
                                               odeint_tsit5_bounded)
from tests.torch_support import one_thread  # noqa: F401  (fixture)


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
    the JAX while_loop does; the sharded error norm takes a process group
    (``group=``, tests/test_torch_parallel.py), not the JAX axis_name."""
    f = lambda y, t: -50.0 * y
    stats = []
    out = odeint_tsit5_adaptive(f, torch.ones(2), torch.linspace(0, 0.5, 3), rtol=1e-6,
                                atol=1e-8, dt0=0.1, max_steps_per_interval=3, stats=stats)
    assert all(a + r == 3 for a, r in stats)
    assert out.shape == (3, 2) and torch.isfinite(out).all()
    with pytest.raises(TypeError, match="axis_name"):
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


# --- odeint_tsit5_bounded and remat ------------------------------------------------

def _decay(y, t):
    return -y


BOUNDED_CASES = {  # tests/test_integrators.py:84-138: analytic, non-autonomous, non-uniform
    "analytic": (_decay, _decay, np.ones(3, np.float32), np.linspace(0, 1, 6, dtype=np.float32),
                 dict(rtol=1e-6, atol=1e-8, substeps_max=6)),
    "nonautonomous": (_cos_jax, _cos_torch, np.zeros(1, np.float32),
                      np.linspace(0, 3, 7, dtype=np.float32), dict(rtol=1e-7, atol=1e-9)),
    "nonuniform": (_cos_jax, _cos_torch, np.zeros(1, np.float32),
                   np.asarray([0.0, 0.01, 0.03, 0.5, 3.0, 5.5], np.float32),
                   dict(rtol=1e-4, atol=1e-6, substeps_max=8)),
}


@pytest.mark.parametrize("name", list(BOUNDED_CASES))
def test_bounded_tsit5_matches_jax(name):
    """The JAX function run op by op on right-hand sides of the same bits:
    the same outputs within 1e-6 relative, every interval ending on its
    save point within its budget; the jitted JAX function (XLA's ``cos``)
    within 1e-6."""
    fj, ft, y0, saveat, kw = BOUNDED_CASES[name]
    with jax.disable_jit():
        ref = np.asarray(jax_bounded(fj, jnp.asarray(y0), jnp.asarray(saveat), **kw))
    stats = []
    out = odeint_tsit5_bounded(ft, torch.from_numpy(y0), torch.from_numpy(saveat), stats=stats,
                               **kw)
    assert out.shape == (len(saveat), *y0.shape) and len(stats) == len(saveat) - 1
    assert all(1 <= a and a + r <= kw.get("substeps_max", 8) for a, r in stats)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    fj_jit = _decay if name == "analytic" else (lambda y, t: jnp.cos(t) * jnp.ones_like(y))
    jit = np.asarray(jax.jit(lambda y: jax_bounded(fj_jit, y, jnp.asarray(saveat), **kw))(
        jnp.asarray(y0)))
    np.testing.assert_allclose(out.numpy(), jit, rtol=1e-6, atol=1e-6)


def _nonlinear(p):
    """A nonlinear, non-autonomous right-hand side of IEEE-rounded +, -, *
    and / only, which both packages compute to the same bits op by op."""
    return lambda y, t: -p[0] * y + p[1] * y * y / (1.0 + y * y) - 0.5 * t * y


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("params", [(0.5, 1.5), (4.0, 0.3)])
def test_bounded_tsit5_gradients_match_jax(params, remat):
    """The nonlinear right-hand side with two parameters, against the JAX
    function run op by op: outputs within 1e-6 relative, and the gradients
    of a loss on every save point with respect to y0 and the parameters
    within 1e-5 (the frozen controller: step sizes and decisions carry no
    gradient on either side)."""
    y0 = np.asarray([1.0, -0.5, 0.25, 2.0], np.float32)
    p0 = np.asarray(params, np.float32)
    saveat = np.linspace(0, 1, 5, dtype=np.float32)
    w = np.linspace(0.5, 1.5, 5 * 4, dtype=np.float32).reshape(5, 4)
    kw = dict(rtol=1e-4, atol=1e-6, substeps_max=5, remat=remat)

    def jloss(y, p):
        out = jax_bounded(_nonlinear(p), y, jnp.asarray(saveat), **kw)
        return jnp.sum(out * w), out

    with jax.disable_jit():
        (_, jout), (jgy, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(y0), jnp.asarray(p0))
    y, p = torch.tensor(y0, requires_grad=True), torch.tensor(p0, requires_grad=True)
    out = odeint_tsit5_bounded(_nonlinear(p), y, torch.from_numpy(saveat), **kw)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=0)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jgy), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp), rtol=1e-5, atol=1e-7)


class _OneRank:
    """A graph group of one rank: its sum is the rank's own."""

    def __init__(self):
        self.calls = 0

    def all_reduce(self, x):
        self.calls += 1
        return x


def test_bounded_tsit5_lands_on_every_save_point_and_refuses_axis_name():
    """With a budget of one substep the forced last step covers each
    interval whole (one accepted try).  The JAX ``axis_name`` is the port's
    ``group``: the error norm's sum and count go through one ``all_reduce``
    a try, and over a group of one rank the tries and the solution are
    those without a group."""
    stats = []
    out = odeint_tsit5_bounded(lambda y, t: -50.0 * y, torch.ones(2), torch.linspace(0, 0.5, 4),
                               substeps_max=1, stats=stats)
    assert stats == [(1, 0)] * 3 and torch.isfinite(out).all()
    saveat, plain, grouped, group = torch.linspace(0, 1, 3), [], [], _OneRank()
    ref = odeint_tsit5_bounded(_decay, torch.ones(2), saveat, stats=plain)
    got = odeint_tsit5_bounded(_decay, torch.ones(2), saveat, stats=grouped, group=group)
    assert grouped == plain and group.calls == sum(a + r for a, r in plain)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
    with pytest.raises(TypeError, match="axis_name"):
        odeint_tsit5_bounded(_decay, torch.ones(2), saveat, axis_name="graph")


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_odeint_fixed_remat_gives_the_same_bits(method, one_thread):
    """remat=True (each step under torch.utils.checkpoint) gives the values
    and gradients of remat=False bit for bit, on a small MLP right-hand
    side with its weights and y0 differentiated."""
    gen = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(6, 16, generator=gen), torch.randn(16, 6, generator=gen)
    y0 = torch.randn(10, 6, generator=gen)
    saveat = torch.linspace(0, 0.5, 6)
    results = []
    for remat in (False, True):
        a, b, y = (x.clone().requires_grad_(True) for x in (w1, w2, y0))
        f = lambda u, t: torch.tanh(u @ a) @ b * torch.cos(t)  # noqa: E731
        out = odeint_fixed(f, y, saveat, method=method, substeps=2, remat=remat)
        (out ** 2).sum().backward()
        results.append([out.detach(), a.grad, b.grad, y.grad])
    for x, ref in zip(*results):
        assert torch.equal(x, ref)
