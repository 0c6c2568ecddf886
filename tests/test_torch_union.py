"""Port: disjoint-union batching (``data/union``), the union and batched
derivative trainers and ``train_network(batchsize=2)`` against the JAX
package on the CPU, f32, noise 0 where values are compared (the two packages
draw different random numbers)."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import init_state as jax_init_state
from mgn_tpu.api import train_network as jax_train_network
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.data.pipeline import Trajectory as JaxTrajectory
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.prep import prepare_trajectory as jax_prepare_trajectory
from mgn_tpu.data.union import union_prepared as jax_union_prepared
from mgn_tpu.train.derivative import DerivativeTrainerConfig as JaxTrainerConfig
from mgn_tpu.train.derivative import make_batched_derivative_trainer as jax_make_batched
from mgn_tpu.train.derivative import make_union_derivative_trainer as jax_make_union
from mgn_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
import mgn_tpu_torch
from mgn_tpu_torch.api import build_model_config
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax, save_train_state_from_jax
from mgn_tpu_torch.core.graph import sender_csr
from mgn_tpu_torch.data.pipeline import Trajectory
from mgn_tpu_torch.data.prep import common_buckets, prepare_trajectory
from mgn_tpu_torch.data.synthetic import (make_channel_mesh, make_trajectory, synthetic_meta,
                                          write_flag_tfrecord_dataset,
                                          write_synthetic_tfrecord_dataset)
from mgn_tpu_torch.data.union import union_prepared
from mgn_tpu_torch.models.mgn import apply_mgn, init_mgn
from mgn_tpu_torch.train.common import TrainState, assemble_graph, param_leaves
from mgn_tpu_torch.train.derivative import (DerivativeTrainerConfig,
                                            make_batched_derivative_trainer,
                                            make_union_derivative_trainer)
from mgn_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(2)

SMALL = dict(mps=2, layer_size=16, hidden_layers=1)
RUN = dict(seed=0, norm_steps=3, checkpoint=5, solver_valid="euler", batchsize=2, **SMALL)
LR = 1e-3
# the trainers' window losses and parameters against the JAX package's
TOL = dict(rtol=1e-3, atol=1e-5)
TL = 7


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ds"))
    write_synthetic_tfrecord_dataset(d, num_nodes=60, tl=6, n_train=3, n_valid=1, n_test=0)
    return d


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _trajectories():
    """Two trajectories on two different meshes of one bucket, with their
    JAX twins: the union's offsets differ per graph."""
    out = []
    for seed in (0, 1):
        pos, cells, nt = make_channel_mesh(60 + 4 * seed, seed=seed)
        vel = make_trajectory(pos, nt, TL, 0.01, seed=10 + seed)
        kw = dict(mesh_pos=pos, node_type=nt, times=np.arange(TL, dtype=np.float32) * 0.01,
                  fields={"velocity": vel}, cells=cells)
        out.append((Trajectory(**kw), JaxTrajectory(**kw)))
    return out


@pytest.fixture(scope="module")
def pair():
    """Both packages' prepared pairs and unions on shared buckets."""
    meta = synthetic_meta(TL, 2, 0)
    trajs = _trajectories()
    nb, eb = common_buckets([t for t, _ in trajs], meta)
    _, spec = build_model_config(meta, Args(**SMALL))
    preps = [prepare_trajectory(t, meta, spec, nb, eb) for t, _ in trajs]
    jstate, jcfg, jspec = jax_init_state(meta, JaxArgs(**SMALL).resolve_auto(), optax.adam(LR))
    jpreps = [jax_prepare_trajectory(j, meta, jspec, nb, eb) for _, j in trajs]
    return dict(meta=meta, preps=preps, jpreps=jpreps, jstate=jstate, jcfg=jcfg, jspec=jspec,
                spec=spec, union=union_prepared(preps), junion=jax_union_prepared(jpreps))


def _real_edge_order(senders, receivers, edge_mask):
    """Edge order by (receiver, sender) over the real edges, the dead ones
    after: the JAX package's native edge builder orders a receiver row by
    sender, the numpy route does not."""
    s, r, m = (np.asarray(x) for x in (senders, receivers, edge_mask))
    live = np.nonzero(m)[0]
    return np.concatenate([live[np.lexsort((s[live], r[live]))], np.nonzero(~m)[0]])


def test_union_prepared_matches_jax(pair):
    tm, fields, times, info = pair["union"]
    jtm, jfields, jtimes, jinfo = pair["junion"]
    n, e = pair["preps"][0].template.num_nodes, pair["preps"][0].template.num_edges
    assert (tm.num_nodes, tm.num_edges) == (jtm.num_nodes, jtm.num_edges) == (2 * n, 2 * e)
    for name in ("receivers", "row_offsets", "node_mask", "edge_mask", "node_type",
                 "node_type_onehot"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jtm, name)),
                                      err_msg=name)
    o, jo = (_real_edge_order(t.senders, t.receivers, t.edge_mask) for t in (tm, jtm))
    np.testing.assert_array_equal(tm.senders.numpy()[o], np.asarray(jtm.senders)[jo])
    np.testing.assert_allclose(tm.mesh_edge_features.numpy()[o],
                               np.asarray(jtm.mesh_edge_features)[jo], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(fields["velocity"].numpy(), np.asarray(jfields["velocity"]))
    np.testing.assert_array_equal(times.numpy(), np.asarray(jtimes))
    np.testing.assert_array_equal(info.node_graph_ids(), jinfo.node_graph_ids())
    assert (info.batch, info.nodes_per_graph, info.edges_per_graph) == (2, n, e)
    # each subgraph keeps its trash row: graph 0's dead edges sit mid-array
    ro = tm.row_offsets.numpy()
    for i, p in enumerate(pair["preps"]):
        real = int(p.template.edge_mask.sum())
        assert ro[(i + 1) * n - 1] == i * e + real and ro[(i + 1) * n] == (i + 1) * e
        assert (tm.senders.numpy()[i * e + real:(i + 1) * e] == (i + 1) * n - 1).all()


def test_union_sender_csr_is_a_fresh_stable_sort(pair):
    tm = pair["union"][0]
    perm, offsets = sender_csr(tm.senders.numpy(), tm.num_nodes)
    np.testing.assert_array_equal(tm.sender_perm.numpy(), perm)
    np.testing.assert_array_equal(tm.sender_offsets.numpy(), offsets)
    assert tm.sender_perm.dtype == tm.sender_offsets.dtype == torch.int32


def test_union_rejects_unequal_buckets_and_lengths(pair):
    meta, spec = pair["meta"], pair["spec"]
    t0, _ = _trajectories()[0]
    other = prepare_trajectory(t0, meta, spec, node_bucket=256)  # another node bucket
    with pytest.raises(ValueError, match="buckets"):
        union_prepared([pair["preps"][0], other])
    p = pair["preps"][0]
    short = type(p)(p.template, {k: v[:3] for k, v in p.fields.items()}, p.times[:3],
                    p.num_nodes, 3)
    with pytest.raises(ValueError, match="lengths"):
        union_prepared([p, short])


def test_union_forward_is_the_per_graph_forwards(pair):
    """The plain path's forward over the union, row for row, is each
    subgraph's own forward (the processor sums no row across graphs)."""
    meta = pair["meta"]
    cfg, spec = build_model_config(meta, Args(**SMALL))
    params = init_mgn(cfg, torch.Generator().manual_seed(0), device="cpu")
    norm = norm_from_jax(_np(pair["jstate"].norm))
    tm, fields, _, _ = pair["union"]

    def fwd(t, f):
        g = assemble_graph(norm, t, {"velocity": f["velocity"][2]}, spec)
        return apply_mgn(params, g, cfg, t.row_offsets)

    with torch.no_grad():
        union = fwd(tm, fields)
        n = pair["preps"][0].template.num_nodes
        for i, p in enumerate(pair["preps"]):
            torch.testing.assert_close(union[i * n:(i + 1) * n], fwd(p.template, p.fields),
                                       rtol=1e-5, atol=1e-6)


def _port_state(jstate):
    params = params_from_jax(_np(jstate.params))
    for p in param_leaves(params):
        p.requires_grad_(True)
    return TrainState(params, _adam(param_leaves(params)), norm_from_jax(_np(jstate.norm)), 0)


def _close_params(port_params, jax_params):
    for a, b in zip(param_leaves(port_params), jax.tree.leaves(jax_params), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


# (delta, B): each step one frame of each subgraph; warm-up steps 0-1
PERMS = np.array([[0, 3], [4, 1], [2, 5], [5, 0]], np.int32)


def test_union_trainer_matches_jax(pair):
    """4 steps from the same weights, noise 0, norm_steps 2: two warm-up
    steps (normalizers only) and two Adam updates, one frame of each
    subgraph a step (different frames, so a per-node dt)."""
    tcfg = JaxTrainerConfig(model=pair["jcfg"], spec=pair["jspec"], noise_stddevs=(0.0,),
                            norm_steps=2)
    jtm, jfields, jtimes, jinfo = pair["junion"]
    jtrain = jax.jit(jax_make_union(tcfg, optax.adam(LR), jinfo.node_graph_ids()))
    jst, jlosses = jtrain(pair["jstate"], jtm, jfields, jtimes, jnp.asarray(PERMS),
                          jax.random.PRNGKey(0))

    cfg, spec = build_model_config(pair["meta"], Args(**SMALL))
    tm, fields, times, info = pair["union"]
    state = _port_state(pair["jstate"])
    before = {f: float(n.num_accumulations) for f, n in state.norm.node.items()
              if hasattr(n, "num_accumulations")}
    train = make_union_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.0,),
                                                                  norm_steps=2),
                                          info.node_graph_ids())
    state, losses = train(state, tm, fields, times, PERMS, torch.Generator().manual_seed(0))
    assert state.step == int(jst.step) == 4
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    _close_params(state.params, jst.params)
    # one accumulation a step over both subgraphs' real nodes
    nodes = sum(p.num_nodes for p in pair["preps"])
    acc = state.norm.node["velocity"]
    assert float(acc.num_accumulations) - before["velocity"] == 4 * nodes
    np.testing.assert_allclose(acc.num_accumulations.numpy(),
                               np.asarray(jst.norm.node["velocity"].num_accumulations))
    for f in ("acc_sum", "acc_sum_sq"):
        np.testing.assert_allclose(getattr(state.norm.output["velocity"], f).numpy(),
                                   np.asarray(getattr(jst.norm.output["velocity"], f)),
                                   rtol=1e-5, atol=1e-5)


def test_batched_trainer_matches_jax(pair):
    """The vmapped variant: the two graphs as a stacked batch in JAX, as
    sequences here; the same 4 steps as the union trainer's test."""
    tcfg = JaxTrainerConfig(model=pair["jcfg"], spec=pair["jspec"], noise_stddevs=(0.0,),
                            norm_steps=2)
    jp = pair["jpreps"]
    templates = jax.tree.map(lambda *xs: jnp.stack(xs), *[p.template for p in jp])
    jfields = {f: jnp.stack([p.fields[f] for p in jp]) for f in jp[0].fields}
    jtimes = jnp.stack([p.times for p in jp])
    jtrain = jax.jit(jax_make_batched(tcfg, optax.adam(LR)))
    jst, jlosses = jtrain(pair["jstate"], templates, jfields, jtimes, jnp.asarray(PERMS),
                          jax.random.PRNGKey(0))

    cfg, spec = build_model_config(pair["meta"], Args(**SMALL))
    preps = pair["preps"]
    state = _port_state(pair["jstate"])
    train = make_batched_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.0,),
                                                                    norm_steps=2))
    state, losses = train(state, [p.template for p in preps], [p.fields for p in preps],
                          [p.times for p in preps], PERMS, torch.Generator().manual_seed(0))
    assert state.step == int(jst.step) == 4
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    _close_params(state.params, jst.params)
    nodes = sum(p.num_nodes for p in preps)
    np.testing.assert_allclose(state.norm.node["velocity"].num_accumulations.numpy(),
                               np.asarray(jst.norm.node["velocity"].num_accumulations))
    assert float(state.norm.edge.num_accumulations) == float(
        jst.norm.edge.num_accumulations) == 4 * sum(int(p.template.edge_mask.sum())
                                                    for p in preps)
    assert float(state.norm.output["velocity"].num_accumulations) == 4 * nodes


def _records(stream: io.StringIO, kind: str):
    return [r for r in map(json.loads, stream.getvalue().splitlines()) if r["kind"] == kind]


def test_train_network_batchsize2_visits_the_same_frames_as_jax(ds_dir, tmp_path):
    """From the JAX package's initial state (converted), the port's
    train_network at batchsize 2 draws the same windows (two 5-frame
    windows of two trajectories each, the three training trajectories
    cycled) and reaches the same losses, validation losses and parameters."""
    meta = jax_load_dataset(ds_dir).meta
    jstate0, _, _ = jax_init_state(meta, JaxArgs(**RUN).resolve_auto(), optax.adam(LR))
    jlog = io.StringIO()
    jstate, jbest = jax_train_network(0.0, optax.adam(LR), ds_dir, str(tmp_path / "cp_jax"),
                                      metrics=JaxMetricsLogger(stream=jlog), steps=10, **RUN)
    cp = str(tmp_path / "cp")
    save_train_state_from_jax(_np(jstate0), cp)
    log = MetricsLogger(quiet=True)
    state, best = mgn_tpu_torch.train_network(0.0, _adam, ds_dir, cp, metrics=log,
                                              device="cpu", steps=10, **RUN)
    ref = _records(jlog, "train")
    got = [r for r in log.records if r["kind"] == "train"]
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [5, 10]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], **TOL)
    ref_valid = _records(jlog, "valid")
    got_valid = [r for r in log.records if r["kind"] == "valid"]
    assert len(got_valid) == len(ref_valid) == 2
    np.testing.assert_allclose([r["loss"] for r in got_valid],
                               [r["loss"] for r in ref_valid], **TOL)
    np.testing.assert_allclose(best, jbest, **TOL)
    _close_params(state.params, jstate.params)


def test_union_resume_k_plus_k_equals_2k(ds_dir, tmp_path):
    """At batchsize 2, 5 steps then 5 more from the checkpoint (its host
    state: frame RNG, trajectory index) give the 10-step run's bits."""
    once, _ = mgn_tpu_torch.train_network(0.0, _adam, ds_dir, str(tmp_path / "a"),
                                          device="cpu", steps=10, **RUN)
    mgn_tpu_torch.train_network(0.0, _adam, ds_dir, str(tmp_path / "b"), device="cpu",
                                steps=5, **RUN)
    log = MetricsLogger(quiet=True)
    twice, _ = mgn_tpu_torch.train_network(0.0, _adam, ds_dir, str(tmp_path / "b"),
                                           metrics=log, device="cpu", steps=10, **RUN)
    assert [r["step"] for r in log.records if r["kind"] == "resume"] == [5]
    assert twice.step == once.step == 10
    for a, b in zip(param_leaves(twice.params), param_leaves(once.params), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sa, sb = twice.optimizer.state_dict()["state"], once.optimizer.state_dict()["state"]
    for i in sa:
        torch.testing.assert_close(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"], rtol=0, atol=0)


def test_cloth_dataset_ignores_batchsize(tmp_path):
    """A cloth dataset goes to the cloth trainer before batchsize is read,
    as in mgn_tpu: batchsize 2 trains one trajectory a step, the bits of
    batchsize 1 (whose run tests/test_torch_cloth_train.py holds against
    the JAX package)."""
    ds = str(tmp_path / "flag")
    write_flag_tfrecord_dataset(ds, nx=30, ny=20, tl=5, n_train=2, n_valid=1, n_test=0)
    kw = dict(device="cpu", steps=4, norm_steps=2, checkpoint=4, seed=0, **SMALL)
    runs = []
    for b in (1, 2):
        log = MetricsLogger(quiet=True)
        state, _ = mgn_tpu_torch.train_network(0.003, _adam, ds, str(tmp_path / f"cp{b}"),
                                               metrics=log, batchsize=b, **kw)
        runs.append((state, [r["loss"] for r in log.records if r["kind"] == "train"]))
    assert runs[0][0].step == runs[1][0].step == 4
    assert runs[0][1] == runs[1][1]
    for a, b in zip(param_leaves(runs[0][0].params), param_leaves(runs[1][0].params),
                    strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
