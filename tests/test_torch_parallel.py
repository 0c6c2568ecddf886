"""The port's graph-parallel core (mgn_tpu_torch.parallel: halo, spmd,
rollout, the synced normalizers) against mgn_tpu.parallel and against the
port's single-device path, on the CPU: two gloo ranks spawned once for the
module (tests/torch_parallel_support.core_rank), the JAX side on the
8-device CPU mesh of tests/conftest.py, weights carried over from JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mgn_tpu.core import normalizers as JN
from mgn_tpu.core.graph import relative_mesh_features
from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.parallel import halo as JH
from mgn_tpu.parallel import partition as JP
from mgn_tpu.parallel import rollout as JR
from mgn_tpu.parallel import spmd as JS
from mgn_tpu.train.common import FieldSpec as JaxFieldSpec
from mgn_tpu.train.common import NormState as JaxNormState
from mgn_tpu.train.common import TrainState as JaxTrainState
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import MeshGraph, build_template
from mgn_tpu_torch.models.mgn import apply_mgn
from mgn_tpu_torch.parallel.mesh import spawn
from mgn_tpu_torch.parallel.partition import global_ids
from mgn_tpu_torch.parallel.spmd import partition_stack
from mgn_tpu_torch.rollout.evaluate import make_rollout_fn
from mgn_tpu_torch.train.common import param_leaves

from tests import torch_parallel_support as S

JAX_SPEC = JaxFieldSpec(fields=("velocity",), target_fields=("velocity",), field_dims=(2,),
                        target_dims=(2,))


def _jax_cfg():
    return JaxMGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2,
                        latent_size=S.LATENT, hidden_layers=S.HIDDEN,
                        message_passing_steps=S.MPS, aggregation_backend="xla")


def _jax_norm(pb):
    """Online normalizers filled from the whole trajectory (JAX side)."""
    mef = relative_mesh_features(pb["pos"], pb["s"], pb["r"])
    vel = pb["vel"]
    return JaxNormState(
        edge=JN.Online.create(3).update(jnp.asarray(mef)),
        node={"velocity": JN.Online.create(2).update(jnp.asarray(vel.reshape(-1, 2))),
              "node_type": JN.OfflineMinMax.create(0.0, 1.0)},
        output={"velocity": JN.Online.create(2).update(
            jnp.asarray((np.diff(vel, axis=0) / S.DT).reshape(-1, 2)))})


def _jax_plan(pb, form):
    exchange, k = S.FORMS[form]
    pt = JP.partition_template(pb["pos"], pb["nt"], pb["s"], pb["r"], pb["num_parts"])
    if exchange == "halo":
        return JP.add_halo_plan(pt, split_boundary=False)
    if exchange == "deep":
        return dataclasses.replace(pt, deep=JP.add_deep_halo_plan(
            pt, pb["pos"], pb["s"], pb["r"], k, S.MPS, build_fused=False))
    return pt


def _jax_forward(jparams, pb, form):
    """mgn_tpu.parallel.halo's forward of ``form`` over mesh (1, 2): (P, N_p, 2)."""
    pt = _jax_plan(pb, form)
    cfg, mesh = _jax_cfg(), JS.make_device_mesh(1, pb["num_parts"])
    nfp = partition_stack(pt, pb["nf"][None])[:, 0]
    exchange, k = S.FORMS[form]
    if exchange == "deep":
        d = pt.deep
        args = (nfp, d.mef, d.src, d.own_pos, d.serve, d.senders, d.receivers, d.edge_mask,
                d.rows)

        def f(nf, mef, src, own, serve, snd, rcv, em, rows):
            return JH.apply_mgn_sharded_deep(jparams, nf[0], mef[0], cfg, "graph", src[0],
                                             own[0], serve[0], snd[0], rcv[0], em[0], rows[0],
                                             k)[None]
    else:
        args = (nfp, pt.mesh_edge_features, pt.senders_global, pt.receivers_local,
                pt.node_mask, pt.edge_mask, pt.row_offsets)
        halo = exchange == "halo"
        if halo:
            args += (pt.halo_serve, pt.senders_halo)

        def f(nf, ef, sg, rl, nm, em, rows, *plan):
            return JH.apply_mgn_sharded(
                jparams, nf[0], ef[0], sg[0], rl[0], nm[0], em[0], cfg, "graph",
                row_offsets=rows[0], halo_serve=plan[0][0] if halo else None,
                senders_halo=plan[1][0] if halo else None)[None]
    fn = shard_map(f, mesh=mesh, in_specs=(P("graph"),) * len(args), out_specs=P("graph"),
                   check_vma=False)
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


def _single_device(params, pb):
    """The port's single-device forward (original node order) and the
    gradient of the weighted sum of its real outputs."""
    cfg = S.model_config()
    t = build_template(pb["pos"], pb["nt"], cells=pb["cells"])
    n = len(pb["pos"])
    nf = np.zeros((t.num_nodes, 9), np.float32)
    nf[:n] = pb["nf"]
    w = np.zeros((t.num_nodes, 2), np.float32)
    w[:n] = pb["w"]
    g = MeshGraph(torch.as_tensor(nf), t.mesh_edge_features * t.edge_mask[:, None], t.senders,
                  t.receivers, t.node_mask, t.edge_mask)
    leaves = [x.detach().clone().requires_grad_(True) for x in param_leaves(params)]
    p2 = _rebuild(params, iter(leaves))
    out = apply_mgn(p2, g, cfg, t.row_offsets, t.sender_perm, t.sender_offsets)
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(), leaves)
    return out.detach().numpy()[:n], [x.numpy() for x in grads]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _split(flat, like):
    out, k = [], 0
    for x in like:
        out.append(flat[k:k + x.size].reshape(x.shape))
        k += x.size
    return out


@pytest.fixture(scope="module")
def case():
    pb = S.problem()
    jparams = jax_init_mgn(jax.random.PRNGKey(0), _jax_cfg())
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    jnorm = _jax_norm(pb)
    norm = norm_from_jax(jax.tree.map(np.asarray, jnorm))
    ranks = spawn(2, S.core_rank, (params, norm, pb))
    return dict(pb=pb, jparams=jparams, params=params, jnorm=jnorm, norm=norm, ranks=ranks,
                single=_single_device(params, pb))


@pytest.mark.parametrize("form", list(S.FORMS))
def test_sharded_forward_matches_jax_and_single_device(case, form):
    """Each exchange form's per-part outputs equal mgn_tpu.parallel's sharded
    forward and, un-permuted, the port's single-device forward (rtol/atol
    1e-5 on the real rows)."""
    pb, ranks = case["pb"], case["ranks"]
    got = np.stack([r["forms"][form][0] for r in ranks])  # (P, N_p, 2)
    pt = S.planned(pb, form)
    mask = pt.node_mask
    ref = _jax_forward(case["jparams"], pb, form)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=1e-5, atol=1e-5)
    flat = got.reshape(-1, 2)[global_ids(pt, len(pb["pos"]))]
    np.testing.assert_allclose(flat, case["single"][0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", list(S.FORMS))
def test_sharded_gradient_matches_single_device(case, form):
    """Every parameter leaf's gradient through the exchange Functions (summed
    over the ranks) equals the single-device gradient (rtol 1e-4, atol
    1e-6), the same on both ranks."""
    ranks, ref = case["ranks"], case["single"][1]
    flat0, flat1 = ranks[0]["forms"][form][1][0], ranks[1]["forms"][form][1][0]
    np.testing.assert_array_equal(flat0, flat1)
    for got, want in zip(_split(flat0, ref), ref):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("form", ["halo", "deep1", "deep4", "gather"])
def test_served_row_sums_are_deterministic(case, form):
    """Two backward passes give the same gradient bits: the halo backward's
    served-row sum runs in a fixed order (K1-perm's, plain on the CPU), the
    all-gather's reduce-scatter in rank order."""
    for r in case["ranks"]:
        first, second = r["forms"][form][1]
        np.testing.assert_array_equal(first, second)


def _jax_step(case, data: int, perms):
    pb = case["pb"]
    pt = _jax_plan(pb, "deep4")
    batch, _, _ = JS.batch_from_partitioned([pt] * data, [{"velocity": pb["vel"]}] * data,
                                            [pb["times"]] * data)
    mesh = JS.make_device_mesh(data, pb["num_parts"])
    opt = optax.adam(1e-3)
    norm = JaxNormState(edge=JN.Online.create(3),
                        node={"velocity": JN.Online.create(2),
                              "node_type": JN.OfflineMinMax.create(0.0, 1.0)},
                        output={"velocity": JN.Online.create(2)})
    state = JaxTrainState(params=case["jparams"], opt_state=opt.init(case["jparams"]),
                          norm=norm, step=jnp.zeros((), jnp.int32))
    step = JS.make_spmd_derivative_step(mesh, _jax_cfg(), JAX_SPEC, opt, noise_stddevs=(0.0,),
                                        norm_steps=0, deep_static=(S.MPS, 0, 0, 0))
    st, losses = step(state, batch.tree(), jnp.asarray(perms, jnp.int32), jax.random.PRNGKey(0))
    return np.asarray(losses), [np.asarray(x) for x in param_leaves(
        jax.tree.map(np.asarray, st.params))], st


def test_spmd_step_matches_jax_mesh_1x2(case):
    """Two noise-free SPMD derivative steps at mesh (1, 2) on the deep plan:
    the losses and the updated parameters equal make_spmd_derivative_step's
    (rtol 1e-4), the normalizer statistics too, the same on both ranks."""
    losses, params, st = _jax_step(case, 1, [[0], [1]])
    for r in case["ranks"]:
        np.testing.assert_allclose(r["step"]["losses"], losses, rtol=1e-4)
        for got, want in zip(r["step"]["params"], params):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    jn = jax.tree.map(np.asarray, st.norm)
    got = case["ranks"][0]["step"]["norm"]
    _same_stats(got["edge"], jn.edge)
    _same_stats(got["output"]["velocity"], jn.output["velocity"])
    for a, b in zip(case["ranks"][0]["step"]["params"], case["ranks"][1]["step"]["params"]):
        np.testing.assert_array_equal(a, b)


_STATS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_sq")


def _same_stats(got, ref):
    """Online accumulators within f32 summation error: the counts equal, the
    sums of squares within rtol 1e-5, the sums (whose terms cancel: an edge
    feature's mean is about 0) within 1e-6 of the rows summed."""
    ref = {f: np.asarray(ref[f] if isinstance(ref, dict) else getattr(ref, f)) for f in _STATS}
    for f in ("acc_count", "num_accumulations"):
        np.testing.assert_array_equal(got[f], ref[f])
    np.testing.assert_allclose(got["acc_sum_sq"], ref["acc_sum_sq"], rtol=1e-5)
    np.testing.assert_allclose(got["acc_sum"], ref["acc_sum"], rtol=1e-5,
                               atol=1e-6 * float(ref["num_accumulations"]))


@pytest.mark.parametrize("steps", [S.TL, 50])
def test_synced_normalizers_equal_single_device_accumulation(case, steps):
    """accumulate_synced_all over the parts' rows, step after step, equals the
    single-device accumulate over the same frames (rtol 1e-5): after one
    pass over the trajectory, and after 50 steps, when a repeated full sync
    (cross_replica_sync) would have grown the sums 2^50-fold."""
    pb = case["pb"]
    t = build_template(pb["pos"], pb["nt"], cells=pb["cells"])
    n = len(pb["pos"])
    node, edge = N.Online.create(2), N.Online.create(3)
    for k in range(steps):
        v = np.zeros((t.num_nodes, 2), np.float32)
        v[:n] = pb["vel"][k % S.TL]
        node = node.update(torch.as_tensor(v), t.node_mask)
        edge = edge.update(t.mesh_edge_features, t.edge_mask)
    for r in case["ranks"]:
        got = r["norms"][steps]
        for name, ref in (("node", node), ("edge", edge)):
            _same_stats(got[name], {f: getattr(ref, f).numpy() for f in _STATS})


@pytest.mark.parametrize("solver", ["euler", "tsit5_adaptive"])
def test_sharded_rollout_matches_jax_and_single_device(case, solver):
    """The sharded rollout (deep plan, forced inflow) equals mgn_tpu's
    make_sharded_rollout_fn and the port's single-device rollout (rtol 1e-4,
    atol 1e-6), its loss JAX's; the adaptive solver's tries per interval
    are the same on both ranks."""
    pb = case["pb"]
    r0, r1 = (r["rollouts"][solver] for r in case["ranks"])
    np.testing.assert_array_equal(r0["pred"], r1["pred"])
    assert r0["tries"] == r1["tries"] and r0["loss"] == r1["loss"]
    if solver == "tsit5_adaptive":
        assert len(r0["tries"]) == S.SAVES[solver] and all(a >= 1 for a, _ in r0["tries"])
    saves = pb["times"][:S.SAVES[solver] + 1]
    pt = _jax_plan(pb, "deep4")
    fn = JR.make_sharded_rollout_fn(JS.make_device_mesh(1, 2), _jax_cfg(), JAX_SPEC,
                                    solver=solver, deep_static=(S.MPS, 0, 0, 0))
    batch = JR.sharded_rollout_batch(pt, {"velocity": pb["vel"]}, JAX_SPEC)
    jpred, jloss = fn(case["jparams"], case["jnorm"], batch, jnp.asarray(saves),
                      jnp.asarray(pb["times"]))
    jfull = JR.unpermute_sharded(pt, np.asarray(jpred), len(pb["pos"]))
    np.testing.assert_allclose(r0["pred"], jfull, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r0["loss"], float(jloss), rtol=1e-4)
    # the port's single-device rollout of the same trajectory
    t = build_template(pb["pos"], pb["nt"], cells=pb["cells"])
    n = len(pb["pos"])
    vel = np.zeros((S.TL, t.num_nodes, 2), np.float32)
    vel[:, :n] = pb["vel"]
    single = make_rollout_fn(S.model_config(), S.SPEC, solver=solver)(
        case["params"], case["norm"], t, {"velocity": torch.as_tensor(vel)},
        torch.as_tensor(saves), torch.as_tensor(pb["times"]))
    np.testing.assert_allclose(r0["pred"], single.numpy()[:, :n], rtol=1e-4, atol=1e-6)


def test_exchanges_are_counted(case):
    """The Comm of the graph group records every exchange: the deep
    rollout's all_to_all calls, and the bytes this rank sent."""
    ex = case["ranks"][0]["rollouts"]["euler"]["exchange"]
    calls, nbytes, ms = ex["all_to_all_single"]
    assert calls >= S.TL - 1 and nbytes > 0 and ms >= 0
