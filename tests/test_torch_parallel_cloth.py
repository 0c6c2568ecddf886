"""The port's graph-parallel cloth family (mgn_tpu_torch.parallel.cloth and
api_cloth with graph_parallel > 1) against mgn_tpu.parallel.cloth and the
port's single-device path, on the CPU: two gloo ranks spawned once for the
module (tests/torch_parallel_train_support.cloth_rank), the JAX side on a
two-device mesh of tests/conftest.py's CPU devices, weights carried over
from JAX."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import mgn_tpu_torch
from mgn_tpu.core.graph import cells_to_edges as jax_cells_to_edges
from mgn_tpu.models.mgn_multi import init_mgn_multi as jax_init_mgn_multi
from mgn_tpu.parallel import cloth as JC
from mgn_tpu.train.cloth import ClothConfig as JaxClothConfig
from mgn_tpu.train.cloth import cloth_model_config as jax_cloth_model_config
from mgn_tpu.train.cloth import make_cloth_norm_state as jax_make_cloth_norm_state
from mgn_tpu.train.common import TrainState as JaxTrainState
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax
from mgn_tpu_torch.data.synthetic import write_flag_tfrecord_dataset
from mgn_tpu_torch.parallel import cloth as C
from mgn_tpu_torch.parallel.mesh import spawn
from mgn_tpu_torch.parallel.partition import global_ids
from mgn_tpu_torch.parallel.rollout import unpermute_sharded
from mgn_tpu_torch.train.strategies import DerivativeTraining
from mgn_tpu_torch.utils.metrics import MetricsLogger

from tests import torch_parallel_train_support as T

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_cloth_train.py's
API = dict(train=dict(steps=6, norm_steps=2, checkpoint=3, mps=1, layer_size=8,
                      hidden_layers=1, seed=0),
           eval=dict(num_rollouts=1, mse_steps=(1, 3), mps=1, layer_size=8, hidden_layers=1))
FLAG_DS = dict(nx=30, ny=20, tl=7, n_train=2, n_valid=1, n_test=1, seed=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(capacity: int = T.CAPACITIES["above"]):
    mcfg = jax_cloth_model_config(T.flag_meta(T.FLAG_T, 1, 1), latent=T.CLOTH_LATENT,
                                  hidden_layers=T.CLOTH_HIDDEN, mps=T.CLOTH_MPS)
    return JaxClothConfig(model=mcfg, world_radius=T.RADIUS, world_capacity=capacity,
                          noise_stddev=0.0, norm_steps=2)


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("graph",))


def _jax_world_edges(cp, capacity: int):
    """mgn_tpu's per-shard world edges of every frame: (T, P, capacity) x 3."""
    pt = JC.partition_cloth(cp["pos"], cp["nt"], cp["s"], cp["r"], 2, type_min=0, type_max=6)
    b = JC.cloth_static_batch(pt)
    wp = JC.partition_field_stack(pt, cp["wp"])

    def f(w, m, sg, rl):
        out = JC.build_world_edges_sharded(w[0], m[0], T.RADIUS, capacity, "graph",
                                           exclude_senders=sg[0], exclude_receivers=rl[0])
        return tuple(x[None] for x in out)

    fn = jax.jit(shard_map(f, mesh=_mesh(), in_specs=(P("graph"),) * 4,
                           out_specs=(P("graph"),) * 3, check_vma=False))
    return [[np.asarray(x) for x in fn(jnp.asarray(wp[t]), b["node_mask"], b["sg"], b["rl"])]
            for t in range(T.FLAG_T)]


def _jax_forward(jparams, jnorm, cp):
    """mgn_tpu's sharded forward at frame 1 (the trainer's features, no
    noise): (P, N_p, 3)."""
    cfg = _jax_cfg()
    pt = JC.partition_cloth(cp["pos"], cp["nt"], cp["s"], cp["r"], 2, type_min=0, type_max=6)
    b = JC.cloth_static_batch(pt)
    wp = jnp.asarray(JC.partition_field_stack(pt, cp["wp"]))
    times = jnp.asarray(cp["times"])

    def f(batch, wps):
        batch = {k: v[0] for k, v in batch.items()}
        prev, cur = wps[0, 0], wps[1, 0]
        vel = (cur - prev) / (times[1] - times[0])
        wp_full, mesh_raw = JC._frame_features(batch, cur, batch["sg"], batch["rl"], "graph")
        ws, wr, wm = JC.build_world_edges_sharded(
            cur, batch["node_mask"], cfg.world_radius, cfg.world_capacity, "graph",
            exclude_senders=batch["sg"], exclude_receivers=batch["rl"], wp_full=wp_full)
        world_raw = JC._world_features(wp_full, cur, ws, wr, wm)
        nf = jnp.concatenate([jnorm.node["velocity"](vel),
                              jnorm.node["node_type"](batch["onehot"])], -1)
        nf = nf * batch["node_mask"][:, None]
        mef = jnorm.edge["mesh"](mesh_raw) * batch["edge_mask"][:, None]
        wef = jnorm.edge["world"](world_raw) * wm[:, None]
        return JC.apply_cloth_sharded(jparams, nf, mef, wef, batch["sg"], batch["rl"],
                                      batch["edge_mask"], batch["rows"], ws, wr, wm, cfg.model,
                                      "graph")[None]

    fn = jax.jit(shard_map(f, mesh=_mesh(), in_specs=(JC._BATCH_SPECS, P(None, "graph")),
                           out_specs=P("graph"), check_vma=False))
    return np.asarray(fn(b, wp))


@pytest.fixture(scope="module")
def case():
    cp = T.cloth_problem()
    cfg = _jax_cfg()
    jparams = jax_init_mgn_multi(jax.random.PRNGKey(0), cfg.model)
    pt = JC.partition_cloth(cp["pos"], cp["nt"], cp["s"], cp["r"], 2, type_min=0, type_max=6)
    windows = {}
    for name, (opt_name, lr) in T.CLOTH_OPTIMIZERS.items():
        opt = getattr(optax, opt_name.lower())(lr)
        state = JaxTrainState(params=jparams, opt_state=opt.init(jparams),
                              norm=jax_make_cloth_norm_state(cfg), step=jnp.zeros((), jnp.int32))
        trainer = JC.make_sharded_cloth_trainer(_mesh(), cfg, opt, cfg.world_capacity)
        windows[name] = trainer(state, JC.cloth_static_batch(pt),
                                jnp.asarray(JC.partition_field_stack(pt, cp["wp"])),
                                jnp.asarray(cp["times"]), jnp.asarray(T.CLOTH_PERM, jnp.int32),
                                jax.random.PRNGKey(0))
    jst = windows["adam"][0]
    params = params_from_jax(_np(jparams))
    norm = norm_from_jax(_np(jst.norm))  # filled by the window: the forward's and rollout's
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(spawn, 2, T.cloth_rank, (params, norm, cp))
        rollout = JC.make_sharded_cloth_rollout(_mesh(), cfg, cfg.world_capacity)(
            jparams, jst.norm, JC.cloth_static_batch(pt),
            jnp.asarray(JC.partition_field_stack(pt, cp["wp"])), jnp.asarray(cp["times"]))
        ref = dict(world={k: _jax_world_edges(cp, c) for k, c in T.CAPACITIES.items()},
                   forward=_jax_forward(jparams, jst.norm, cp), windows=windows,
                   params0=jax.tree.leaves(_np(jparams)),
                   rollout=JC.unpermute_field_stack(pt, np.asarray(rollout), len(cp["pos"])))
        return dict(cp=cp, pt=pt, ranks=ranks.result(), jax=ref)


def test_partition_and_stacks_equal_jax():
    """The cloth partition (partition_template) and the field stacks'
    layout (partition_field_stack, unpermute_sharded) equal
    mgn_tpu.parallel.cloth's partition_cloth and stacks bit for bit."""
    cp = T.cloth_problem()
    s, r = jax_cells_to_edges(cp["cells"])
    jpt = JC.partition_cloth(cp["pos"], cp["nt"], s, r, 2, type_min=0, type_max=6)
    tpt = T.cloth_partition(cp)
    for f in ("node_type_onehot", "mesh_edge_features", "senders_global", "receivers_local",
              "row_offsets", "node_mask", "edge_mask", "node_type", "perm"):
        np.testing.assert_array_equal(getattr(tpt, f), getattr(jpt, f), err_msg=f)
    stack = C.partition_field_stack(tpt, cp["wp"])
    np.testing.assert_array_equal(stack, JC.partition_field_stack(jpt, cp["wp"]))
    np.testing.assert_array_equal(unpermute_sharded(tpt, stack, len(cp["pos"])), cp["wp"])


@pytest.mark.parametrize("name", list(T.CAPACITIES))
def test_world_edges_sharded_equal_jax(case, name):
    """Each part's world edges at every frame equal mgn_tpu's
    build_world_edges_sharded: the same senders, receivers and mask, in the
    same order, below its capacity and past it (the first hits kept)."""
    cap = T.CAPACITIES[name]
    counts = []
    for p, r in enumerate(case["ranks"]):
        for t in range(T.FLAG_T):
            got, ref = r["world"][name][t], [x[p] for x in case["jax"]["world"][name][t]]
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
            counts.append(int(got[2].sum()))
    assert (max(counts) == cap) == (name == "below") and min(counts) > 0


def test_world_edge_union_equals_single_device(case):
    """Where no part overflows, the parts' world edges together are the
    single-device set of every frame (in the dataset's node order)."""
    cp, pt = case["cp"], case["pt"]
    gid = global_ids(pt, len(cp["pos"]))
    orig = np.full(pt.num_parts * pt.part_nodes, -1)
    orig[gid] = np.arange(len(cp["pos"]))
    single = T.single_world_edges(cp, T.CAPACITIES["above"])
    for t in range(T.FLAG_T):
        union = set()
        for p, r in enumerate(case["ranks"]):
            s, rv, m = r["world"]["above"][t]
            union |= {(int(orig[a]), int(orig[p * pt.part_nodes + b]))
                      for a, b in zip(s[m], rv[m])}
        assert union == single[t] and len(union) > 0


def test_sharded_cloth_forward_matches_jax(case):
    """apply_cloth_sharded (each round one fused_process(mps=1) over the
    gathered latents, the world set's offset zero on the other part's rows)
    equals mgn_tpu's apply_cloth_sharded on the real rows (rtol 1e-4)."""
    got = np.stack([r["forward"] for r in case["ranks"]])
    mask = case["pt"].node_mask
    np.testing.assert_allclose(got[mask], case["jax"]["forward"][mask], **TOL)


@pytest.mark.parametrize("opt", list(T.CLOTH_OPTIMIZERS))
def test_sharded_cloth_trainer_window_matches_jax(case, opt):
    """One noise-free window of four frames (two warm-up steps, two
    updates): the losses, the parameters and every normalizer equal
    make_sharded_cloth_trainer's, the same bits on both ranks.  With SGD the
    update is the gradient summed over the parts: each leaf's update equals
    JAX's within rtol 1e-4 of the leaf's largest (a gradient scaled by the
    part count would be off by 100%)."""
    jst, jlosses = case["jax"]["windows"][opt]
    r0, r1 = (r["train"][opt] for r in case["ranks"])
    assert r0["step"] == r1["step"] == int(jst.step) == len(T.CLOTH_PERM)
    np.testing.assert_allclose(r0["losses"], np.asarray(jlosses), **TOL)
    ref = jax.tree.leaves(_np(jst.params))
    assert len(r0["params"]) == len(ref)
    for a, b in zip(r0["params"], ref):
        np.testing.assert_allclose(a, b, **TOL)
    if opt == "sgd":
        for a, b, p0 in zip(r0["params"], ref, case["jax"]["params0"]):
            upd, want = a - p0, b - p0
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(upd, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    for a, b in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(a, b)
    jn = _np(jst.norm)
    pairs = [(r0["norm"]["edge"][k], jn.edge[k]) for k in ("mesh", "world")]
    pairs += [(r0["norm"]["node"]["velocity"], jn.node["velocity"]),
              (r0["norm"]["output"]["acceleration"], jn.output["acceleration"])]
    for a, b in pairs:
        for f in ("acc_sum", "acc_sum_sq", "num_accumulations", "acc_count"):
            np.testing.assert_allclose(a[f], np.asarray(getattr(b, f)), rtol=1e-5, atol=1e-5,
                                       err_msg=f)


def test_sharded_cloth_rollout_matches_jax(case):
    """The sharded semi-implicit rollout, gathered and un-permuted, equals
    make_sharded_cloth_rollout's (rtol 1e-4), the same on both ranks."""
    r0, r1 = (r["rollout"] for r in case["ranks"])
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_allclose(r0, case["jax"]["rollout"], **TOL)


def test_world_edge_key_overflow_raises():
    """N_tot * N_p at 2^31 or more overflows the int32 ranking key: refused
    before any pair is scanned."""
    wp_full, mask_full = torch.zeros(65536, 3), torch.ones(65536, dtype=torch.bool)
    with pytest.raises(ValueError, match="overflows int32"):
        C.build_world_edges_sharded(torch.zeros(32768, 3), torch.ones(32768, dtype=torch.bool),
                                    0.05, 16, None, wp_full=wp_full, mask_full=mask_full)


@pytest.fixture(scope="module")
def api_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("cloth_api")
    ds = str(work / "ds")
    write_flag_tfrecord_dataset(ds, **FLAG_DS)
    ranks = spawn(2, T.cloth_api_rank, (ds, str(work), API))
    log = MetricsLogger(quiet=True)
    state, best = mgn_tpu_torch.train_network(
        0.0, lambda ps: torch.optim.Adam(ps, lr=T.CLOTH_LR), ds, str(work / "cp_single"),
        device="cpu", metrics=log, training_strategy=DerivativeTraining(random=False),
        **API["train"])
    reports = mgn_tpu_torch.eval_network(ds, str(work / "cp_single"), str(work / "out_single"),
                                         device="cpu", **API["eval"])
    return dict(ranks=ranks, best=best, reports=reports,
                losses=[r["loss"] for r in log.records if r["kind"] == "train"],
                valid=[r["loss"] for r in log.records if r["kind"] == "valid"])


def test_cloth_train_and_eval_network_graph_parallel_match_single_device(api_runs):
    """train_network and eval_network with graph_parallel=2 on a flag
    dataset (through api_cloth): the training and validation losses, the
    best loss and the evaluation's errors equal the single-device run's
    (rtol 1e-4); rank 0 alone logs and exports."""
    r0, r1 = api_runs["ranks"]
    assert len(r0["losses"]) == len(api_runs["losses"]) >= 2 and not r1["losses"]
    np.testing.assert_allclose(r0["losses"], api_runs["losses"], **TOL)
    np.testing.assert_allclose(r0["valid"], api_runs["valid"], **TOL)
    np.testing.assert_allclose(r0["best"], api_runs["best"], **TOL)
    for a, b in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(a, b)
    for r in (r0, r1):
        np.testing.assert_allclose(r["reports"][0]["error"], api_runs["reports"][0]["error"],
                                   rtol=1e-4, atol=1e-7)
    assert len(r0["exports"]) == 1 and not r1["exports"]
