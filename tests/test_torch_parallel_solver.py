"""The port's graph-parallel solver training (mgn_tpu_torch.parallel.spmd.
make_spmd_solver_step: SolverTraining with Euler, RK4 with remat and the
bounded adaptive Tsit5, MultipleShooting with Euler) against
mgn_tpu.parallel.spmd.make_spmd_solver_step at mesh (1, 2) on the deep
plan, on the CPU: two gloo ranks spawned once for the module
(tests/torch_parallel_train_support.solver_rank), the JAX side on the
8-device CPU mesh of tests/conftest.py, weights carried over from JAX."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mgn_tpu.core import normalizers as JN
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.parallel import partition as JP
from mgn_tpu.parallel import spmd as JS
from mgn_tpu.rollout.dynamics import make_deriv_fn as jax_make_deriv_fn
from mgn_tpu.rollout.integrators import odeint_tsit5_bounded as jax_tsit5_bounded
from mgn_tpu.train import strategies as JT
from mgn_tpu.train.common import FieldSpec as JaxFieldSpec
from mgn_tpu.train.common import NormState as JaxNormState
from mgn_tpu.train.common import TrainState as JaxTrainState
from mgn_tpu.train.common import type_mask as jax_type_mask
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.parallel.mesh import spawn

from tests import torch_parallel_support as S
from tests import torch_parallel_train_support as T

JAX_SPEC = JaxFieldSpec(fields=("velocity",), target_fields=("velocity",), field_dims=(2,),
                        target_dims=(2,))
_STATS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_sq")


def _jax_cfg():
    return JaxMGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2,
                        latent_size=S.LATENT, hidden_layers=S.HIDDEN,
                        message_passing_steps=S.MPS, aggregation_backend="xla")


def _jax_strategy(case):
    cls, kw = T.SOLVER_CASES[case]
    return getattr(JT, cls.__name__)(**kw)


def _fresh_jax_state(jparams, opt):
    norm = JaxNormState(edge=JN.Online.create(3),
                        node={"velocity": JN.Online.create(2),
                              "node_type": JN.OfflineMinMax.create(0.0, 1.0)},
                        output={"velocity": JN.Online.create(2)})
    return JaxTrainState(params=jparams, opt_state=opt.init(jparams), norm=norm,
                         step=jnp.zeros((), jnp.int32))


def _jax_steps(case, jparams, pb):
    """Two steps of mgn_tpu's sharded solver step at mesh (1, 2) on the deep
    plan (SGD): the states after each and the losses."""
    pt = JP.partition_template(pb["pos"], pb["nt"], pb["s"], pb["r"], 2)
    pt = dataclasses.replace(pt, deep=JP.add_deep_halo_plan(pt, pb["pos"], pb["s"], pb["r"],
                                                            S.MPS, S.MPS, build_fused=False))
    batch, _, _ = JS.batch_from_partitioned([pt], [{"velocity": pb["vel"]}], [pb["times"]])
    opt = optax.sgd(T.SOLVER_LR)
    step = JS.make_spmd_solver_step(JS.make_device_mesh(1, 2), _jax_cfg(), JAX_SPEC,
                                    _jax_strategy(case), opt, norm_steps=0,
                                    deep_static=(S.MPS, 0, 0, 0))
    states, losses, st = [], [], _fresh_jax_state(jparams, opt)
    for _ in range(2):
        st, loss = step(st, batch.tree(), jax.random.PRNGKey(0))
        states.append(st)
        losses.append(float(loss))
    return states, losses


def _jax_tries(pb, params, norm, strategy, rows: int):
    """The bounded Tsit5's (accepted, rejected) tries per interval in the
    JAX function on the single-device network over a template of ``rows``
    rows, the sharded error norm's element count: every right-hand side
    call's time is recorded in order (an ordered ``jax.debug.callback``);
    each substep's first stage is at its start time, which an accepted try
    advances."""
    n = len(pb["pos"])
    t = jax_build_template(pb["pos"], pb["nt"], cells=pb["cells"], node_bucket=rows)
    vel = np.zeros((S.TL, t.num_nodes, 2), np.float32)
    vel[:, :n] = pb["vel"]
    n_save = int(round((strategy.tstop - strategy.tstart) / strategy.dt)) + 1
    saveat = strategy.tstart + np.arange(n_save, dtype=np.float32) * np.float32(strategy.dt)
    eps = 1e-4 * np.min(np.diff(pb["times"]))
    fidx = np.clip(np.searchsorted(pb["times"], saveat + eps, side="right") - 1, 0, S.TL - 1)
    gt = jnp.asarray(vel[fidx])
    val = (jax_type_mask(t.node_type, (0, 5)) & t.node_mask).astype(jnp.float32)
    inflow = jax_type_mask(t.node_type, (1,)) & t.node_mask
    deriv = jax_make_deriv_fn(params, _jax_cfg(), norm, t, JAX_SPEC, {}, val,
                              inflow_mask=inflow, forcing_data=gt,
                              forcing_times=jnp.asarray(saveat))
    starts = []

    def f(y, tt):
        jax.debug.callback(lambda x: starts.append(np.float32(x)), tt, ordered=True)
        return deriv(y, tt)

    sub = strategy.adaptive_substeps
    jax.jit(lambda y0: jax_tsit5_bounded(f, y0, jnp.asarray(saveat), rtol=strategy.rtol,
                                         atol=strategy.atol, substeps_max=sub))(gt[0])
    jax.effects_barrier()
    first = np.asarray(starts[::7], np.float32).reshape(n_save - 1, sub)
    tries = []
    for k, ts in enumerate(first):
        t1, width = saveat[k + 1], saveat[k + 1] - saveat[k]
        acc = rej = 0
        for i in range(sub):
            if not t1 - ts[i] > np.float32(1e-7) * abs(width):
                break
            if i == sub - 1 or ts[i + 1] != ts[i]:
                acc += 1
            else:
                rej += 1
        tries.append((acc, rej))
    return tries


@pytest.fixture(scope="module")
def case():
    pb = S.problem()
    jparams = jax_init_mgn(jax.random.PRNGKey(0), _jax_cfg())
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(spawn, 2, T.solver_rank, (params, pb))
        jax_runs = {c: _jax_steps(c, jparams, pb) for c in T.SOLVER_CASES}
        return dict(pb=pb, jparams=jparams, ranks=ranks.result(), jax=jax_runs)


@pytest.mark.parametrize("name", list(T.SOLVER_CASES))
def test_spmd_solver_step_matches_jax_mesh_1x2(case, name):
    """Two noise-free sharded solver steps (SGD): the losses and the updated
    parameters equal make_spmd_solver_step's (rtol 1e-4, atol 1e-6), the
    same bits on both ranks, the step counted twice."""
    states, losses = case["jax"][name]
    r0, r1 = (r[name] for r in case["ranks"])
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4)
    ref = jax.tree.leaves(jax.tree.map(np.asarray, states[-1].params))
    assert len(r0["params"]) == len(ref)
    for got, want in zip(r0["params"], ref):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert r0["losses"] == r1["losses"] and r0["step"] == r1["step"] == 2
    for a, b in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(T.SOLVER_CASES))
def test_spmd_solver_step_normalizers_match_jax(case, name):
    """The normalizers after two steps (the save frames, their differences
    over the save grid's interval and the parts' own edges, synced): the
    counts equal JAX's, the sums within f32 summation error, the same bits
    on both ranks."""
    jn = jax.tree.map(np.asarray, case["jax"][name][0][-1].norm)
    got = [r[name]["norm"] for r in case["ranks"]]
    for a, b in ((got[0]["edge"], jn.edge), (got[0]["node"]["velocity"], jn.node["velocity"]),
                 (got[0]["output"]["velocity"], jn.output["velocity"])):
        for f in ("acc_count", "num_accumulations"):
            np.testing.assert_array_equal(a[f], np.asarray(getattr(b, f)))
        np.testing.assert_allclose(a["acc_sum_sq"], np.asarray(b.acc_sum_sq), rtol=1e-5)
        np.testing.assert_allclose(a["acc_sum"], np.asarray(b.acc_sum), rtol=1e-5,
                                   atol=1e-6 * float(np.asarray(b.num_accumulations)))
    for f in _STATS:
        np.testing.assert_array_equal(got[0]["edge"][f], got[1]["edge"][f])


def test_bounded_tsit5_takes_the_same_tries_on_every_rank_and_in_jax(case):
    """The bounded Tsit5's error norm is summed over the graph group: both
    ranks take the same tries in each step's solve, and they are the JAX
    function's over the same element count (run op by op from the JAX
    sharded step's parameters and normalizers)."""
    pb = case["pb"]
    states, _ = case["jax"]["tsit5"]
    r0, r1 = (r["tsit5"]["tries"] for r in case["ranks"])
    assert r0 == r1 and len(r0) == 2
    strategy = T.solver_strategy("tsit5")
    rows = 2 * S.planned(pb, "deep4").part_nodes
    params = [case["jparams"], states[0].params]
    for k in range(2):
        assert [tuple(x) for x in r0[k]] == _jax_tries(pb, params[k], states[k].norm, strategy,
                                                       rows)
    assert all(a >= 1 for a, _ in r0[0])


def test_nan_frame_skips_the_update_on_every_rank(case):
    """A NaN frame on rank 0's part: the summed loss is not finite, and
    both ranks keep their parameters while the step advances."""
    for r in case["ranks"]:
        nan = r["nan"]
        assert not np.isfinite(nan["loss"]) and nan["unchanged"] and nan["step"] == 1
