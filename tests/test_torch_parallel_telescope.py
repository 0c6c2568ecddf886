"""The telescoped deep stages (mgn_tpu_torch.parallel.partition.TelescopeStage,
add_deep_halo_plan(telescope=), halo.apply_mgn_sharded_deep(stages=),
Args.telescope_stages) against mgn_tpu.parallel and the port's single-device
path, on the CPU: two gloo ranks spawned once for the module
(tests/torch_parallel_train_support.telescope_rank), the JAX side on the
8-device CPU mesh of tests/conftest.py, weights carried over from JAX."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mgn_tpu.data.synthetic import make_channel_mesh as jax_channel_mesh
from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.parallel import halo as JH
from mgn_tpu.parallel import partition as JP
from mgn_tpu.parallel import spmd as JS
from mgn_tpu_torch.api_spmd import telescope_split
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.core.graph import MeshGraph, build_template, cells_to_edges
from mgn_tpu_torch.data.synthetic import write_synthetic_tfrecord_dataset
from mgn_tpu_torch.models.mgn import apply_mgn
from mgn_tpu_torch.parallel import partition as TP
from mgn_tpu_torch.parallel.mesh import spawn
from mgn_tpu_torch.parallel.partition import global_ids
from mgn_tpu_torch.parallel.spmd import partition_stack
from mgn_tpu_torch.train.common import param_leaves

from tests import torch_parallel_support as S
from tests import torch_parallel_train_support as T

STAGE_FIELDS = ("nremap", "eremap", "own_pos", "senders", "receivers", "edge_mask", "rows")
PLAN_FIELDS = ("src", "own_pos", "serve", "serve_mask", "senders", "receivers", "edge_mask",
               "mef", "rows")
TRAIN = dict(mps=S.MPS, layer_size=S.LATENT, hidden_layers=S.HIDDEN, norm_steps=2,
             checkpoint=3, solver_valid="euler", seed=0)


def _jax_cfg():
    return JaxMGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2,
                        latent_size=S.LATENT, hidden_layers=S.HIDDEN,
                        message_passing_steps=S.MPS, aggregation_backend="xla")


def _jax_forward(jparams, pb, name):
    """mgn_tpu.parallel.halo's telescoped deep forward over mesh (1, 2): (P, N_p, 2)."""
    k, tel = T.TELESCOPES[name]
    pt = JP.partition_template(pb["pos"], pb["nt"], pb["s"], pb["r"], 2)
    d = JP.add_deep_halo_plan(pt, pb["pos"], pb["s"], pb["r"], k, S.MPS, build_fused=False,
                              telescope=tel)
    nfp = partition_stack(pt, pb["nf"][None])[:, 0]
    stages = [{f: jnp.asarray(getattr(st, f)) for f in STAGE_FIELDS} for st in d.stages]
    cfg = _jax_cfg()

    def f(nf, mef, src, own, serve, snd, rcv, em, rows, stg):
        sts = [dict({kk: v[0] for kk, v in sd.items()}, rounds=st.rounds, plan=None)
               for sd, st in zip(stg, d.stages)]
        return JH.apply_mgn_sharded_deep(jparams, nf[0], mef[0], cfg, "graph", src[0], own[0],
                                         serve[0], snd[0], rcv[0], em[0], rows[0], k,
                                         stages=sts, stage0_rounds=d.stage0_rounds)[None]

    args = [jnp.asarray(a) for a in (nfp, d.mef, d.src, d.own_pos, d.serve, d.senders,
                                     d.receivers, d.edge_mask, d.rows)] + [stages]
    fn = shard_map(f, mesh=JS.make_device_mesh(1, 2), in_specs=(P("graph"),) * 10,
                   out_specs=P("graph"), check_vma=False)
    return np.asarray(jax.jit(fn)(*args))


def _single_device(params, pb):
    """The port's single-device forward (original node order) and the
    gradient of the weighted sum of its real outputs."""
    t = build_template(pb["pos"], pb["nt"], cells=pb["cells"])
    n = len(pb["pos"])
    nf = np.zeros((t.num_nodes, 9), np.float32)
    nf[:n] = pb["nf"]
    w = np.zeros((t.num_nodes, 2), np.float32)
    w[:n] = pb["w"]
    g = MeshGraph(torch.as_tensor(nf), t.mesh_edge_features * t.edge_mask[:, None], t.senders,
                  t.receivers, t.node_mask, t.edge_mask)
    p = S._clone(params)
    out = apply_mgn(p, g, S.model_config(), t.row_offsets, t.sender_perm, t.sender_offsets)
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(), param_leaves(p))
    return out.detach().numpy()[:n], np.concatenate([x.reshape(-1).numpy() for x in grads])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    pb = S.problem()
    jparams = jax_init_mgn(jax.random.PRNGKey(0), _jax_cfg())
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    work = tmp_path_factory.mktemp("telescope")
    ds = str(work / "ds")
    write_synthetic_tfrecord_dataset(ds, num_nodes=S.NODES, tl=S.TL, n_train=2, n_valid=1,
                                     n_test=1)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(spawn, 2, T.telescope_rank, (params, pb, ds, str(work), TRAIN))
        ref = {name: _jax_forward(jparams, pb, name) for name in T.TELESCOPES}
        return dict(pb=pb, ranks=ranks.result(), jax=ref, single=_single_device(params, pb))


@pytest.mark.parametrize("k,telescope", [(4, (2, 2)), (4, (1, 1, 1, 1)), (2, (1, 1)),
                                         (4, (2, 1, 1))])
def test_telescope_tables_equal_jax(k, telescope):
    """add_deep_halo_plan(telescope=) over the four-part channel mesh of
    tests/test_parallel.py's telescope cases: the plan and every stage's
    tables equal mgn_tpu's bit for bit (dtypes included), every stage is
    smaller than the extended table and passes kernel_tables' checks."""
    pos, cells, nt = jax_channel_mesh(400, seed=1)
    s, r = cells_to_edges(cells)
    jpt = JP.partition_template(pos, nt, s, r, 4, spatial_order=True)
    tpt = TP.partition_template(pos, nt, s, r, 4, spatial_order=True)
    jd = JP.add_deep_halo_plan(jpt, pos, s, r, k, 4, build_fused=False, telescope=telescope)
    td = TP.add_deep_halo_plan(tpt, pos, s, r, k, 4, telescope=telescope)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f), err_msg=f)
    assert td.stage0_rounds == jd.stage0_rounds == telescope[0]
    assert len(td.stages) == len(jd.stages) == len(telescope) - 1
    for a, b in zip(td.stages, jd.stages):
        assert (a.rounds, a.depth, a.n_ext) == (b.rounds, b.depth, b.n_ext)
        assert a.n_ext <= td.n_ext
        for f in STAGE_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        for p in range(4):
            TP.kernel_tables(a.senders[p], a.receivers[p], a.rows[p], a.edge_mask[p], a.n_ext,
                             "cpu")


def test_telescope_must_sum_to_the_rounds():
    pb = S.problem()
    pt = TP.partition_template(pb["pos"], pb["nt"], pb["s"], pb["r"], 2)
    with pytest.raises(ValueError, match="sum to rounds"):
        TP.add_deep_halo_plan(pt, pb["pos"], pb["s"], pb["r"], 4, S.MPS, telescope=(2, 1))


@pytest.mark.parametrize("name", list(T.TELESCOPES))
def test_telescoped_forward_matches_jax_and_single_device(case, name):
    """Each telescoped plan's per-part outputs equal mgn_tpu's
    apply_mgn_sharded_deep(stages=) (rtol 1e-5) and, un-permuted, the port's
    single-device forward; the stages' tables shrink."""
    pb = case["pb"]
    got = np.stack([r["forms"][name]["out"] for r in case["ranks"]])
    pt = T.telescoped(pb, name)
    mask = pt.node_mask
    np.testing.assert_allclose(got[mask], case["jax"][name][mask], rtol=1e-5, atol=1e-5)
    flat = got.reshape(-1, 2)[global_ids(pt, len(pb["pos"]))]
    np.testing.assert_allclose(flat, case["single"][0], rtol=1e-5, atol=1e-5)
    form = case["ranks"][0]["forms"][name]
    assert len(form["rows"]) == len(T.TELESCOPES[name][1]) - 1
    assert all(n <= form["ext"][0] and e <= form["ext"][1] for n, e in form["rows"])


@pytest.mark.parametrize("name", list(T.TELESCOPES))
def test_telescoped_gradient_matches_single_device(case, name):
    """The gradient through the telescoped stages (the edge latents
    gathered from and written back into the stage-0 buffer), summed over
    the ranks, equals the single-device gradient (rtol 1e-4, atol 1e-6),
    the same bits on both ranks."""
    g0, g1 = (r["forms"][name]["grads"] for r in case["ranks"])
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_allclose(g0, case["single"][1], rtol=1e-4, atol=1e-6)


def test_train_network_with_telescope_stages_matches_untelescoped(case):
    """train_network(graph_parallel=2, telescope_stages=2) trains as the
    untelescoped deep plan does: losses (rank 0 logs them) and parameters
    within rtol 1e-4."""
    plain, tel = (case["ranks"][0]["train"][k] for k in (None, 2))
    assert len(tel["losses"]) == len(plain["losses"]) == 3
    np.testing.assert_allclose(tel["losses"], plain["losses"], rtol=1e-4)
    for r in case["ranks"]:
        plain, tel = r["train"][None], r["train"][2]
        for a, b in zip(tel["params"], plain["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rounds,stages,split", [
    (15, 3, (5, 5, 5)), (4, 3, (2, 1, 1)), (2, 5, (1, 1)), (15, None, None), (15, 1, None),
    (0, 3, None)])
def test_telescope_split_is_the_jax_planners(rounds, stages, split):
    """Args.telescope_stages: min(stages, rounds) near-equal stages, the
    longer first, and none without a deep plan (mgn_tpu/api.py's rule)."""
    assert telescope_split(rounds, stages) == split
