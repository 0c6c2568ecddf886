"""Port: cloth training (FlagSimple) — K5's node_extra form (plain
version), the differentiable ``fused_process(node_extra=<tensor>)``, the
two-edge-set model's gradient, the cloth trainer, the TFRecord flag
dataset and ``train_network`` on it — against the JAX package on the CPU,
f32 (bf16 where stated), noise 0 where values are compared (the two
packages draw different random numbers, ROADMAP C6)."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api_cloth import init_cloth_state as jax_init_cloth_state
from mgn_tpu.api import train_network as jax_train_network
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.synthetic import write_flag_dataset as jax_write_flag_dataset
from mgn_tpu.models.mgn_multi import MultiMGNConfig as JaxMultiMGNConfig
from mgn_tpu.models.mgn_multi import apply_mgn_multi as jax_apply_mgn_multi
from mgn_tpu.models.mgn_multi import init_mgn_multi as jax_init_mgn_multi
from mgn_tpu.models.mlp import apply_mlp_parts as jax_apply_mlp_parts
from mgn_tpu.models.mlp import init_mlp as jax_init_mlp
from mgn_tpu.ops.fused import fused_process as jax_fused_process
from mgn_tpu.train.cloth import ClothConfig as JaxClothConfig
from mgn_tpu.train.cloth import cloth_model_config as jax_cloth_model_config
from mgn_tpu.train.cloth import make_cloth_norm_state as jax_make_cloth_norm_state
from mgn_tpu.train.cloth import make_cloth_trainer as jax_make_cloth_trainer
from mgn_tpu.train.common import TrainState as JaxTrainState
from mgn_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
import mgn_tpu_torch
from mgn_tpu_torch.convert import (adam_state_from_jax, norm_from_jax, params_from_jax,
                                   save_train_state_from_jax)
from mgn_tpu_torch.core.graph import build_template
from mgn_tpu_torch.data.synthetic import (flag_meta, make_flag_mesh, make_flag_trajectory,
                                          write_flag_tfrecord_dataset)
from mgn_tpu_torch.models.mgn_multi import MultiMGNConfig, apply_mgn_multi
from mgn_tpu_torch.ops.fused import (cast_mlp, fused_process, node_round_bwd,
                                     node_round_bwd_plain)
from mgn_tpu_torch.ops.segment import csr_order, gather_ordered
from mgn_tpu_torch.train.cloth import ClothConfig, cloth_model_config, make_cloth_trainer
from mgn_tpu_torch.train.common import TrainState, param_leaves
from mgn_tpu_torch.train.strategies import SolverTraining
from mgn_tpu_torch.utils.metrics import MetricsLogger
from tests.test_torch_cloth import multi_case
from tests.torch_support import one_thread  # noqa: F401  (fixture)

torch.set_num_threads(2)

GRAD_TOL = dict(rtol=2e-3, atol=2e-4)  # the JAX package's own fused-gradient tolerance
TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3
SMALL = dict(mps=2, layer_size=16, hidden_layers=1)
RUN = dict(seed=0, norm_steps=3, checkpoint=5, **SMALL)
FLAG_DS = dict(nx=30, ny=20, tl=7, n_train=2, n_valid=1, n_test=0, seed=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _requires_grad(tree):
    for t in param_leaves(tree):
        t.requires_grad_(True)
    return tree


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- K5's node_extra form, plain version ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("latent", [16, 128])
def test_node_round_bwd_plain_extra_matches_jax_vjp(latent, dtype):
    """dv, dagg and dxtr against jax.vjp of apply_mlp_parts(extra=); a zero
    extra (the ReLU masks of another forward) gives another result."""
    rng = np.random.default_rng(latent)
    n = 40
    mlp = _np(jax_init_mlp(jax.random.PRNGKey(latent), 2 * latent, latent, 2, latent,
                           layer_norm=True))
    mlp["b"] = [rng.normal(size=b.shape).astype(np.float32) * 0.1 for b in mlp["b"]]
    v, agg, dv = (rng.normal(size=(n, latent)).astype(np.float32) for _ in range(3))
    extra = (rng.normal(size=(n, latent)) * 2).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jv, jagg, jdv = (jnp.asarray(x).astype(jd) for x in (v, agg, dv))
    _, vjp = jax.vjp(lambda a, b, x: jax_apply_mlp_parts(mlp, (a, b), jd, extra=x),
                     jv, jagg, jnp.asarray(extra))
    dv_p, dagg, dxtr = vjp(jdv)
    ref = [np.asarray((jdv + dv_p).astype(jnp.float32)), np.asarray(dagg.astype(jnp.float32)),
           np.asarray(dxtr)]
    tv, tagg, tdv = (torch.from_numpy(x).to(td) for x in (v, agg, dv))
    m = cast_mlp(params_from_jax(mlp), td)
    new_dv, t_dagg, saved, t_dxtr = node_round_bwd_plain(tdv, tv, tagg, m,
                                                        torch.from_numpy(extra))
    got = [new_dv.float().numpy(), t_dagg.numpy(), t_dxtr.numpy()]
    assert t_dxtr.dtype == torch.float32 and torch.equal(t_dxtr, saved.dh[0].float())
    for name, a, b in zip(("dv", "dagg", "dxtr"), got, ref):
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            assert _rel_l2(a, b) <= 2e-2, (name, _rel_l2(a, b))
    # the wrapper on a CPU tensor: the same plain version, the carry in place
    carry = tdv.clone()
    out = node_round_bwd(carry, tv, tagg, m, None, torch.from_numpy(extra))
    assert len(out) == 3 and torch.equal(carry, new_dv) and torch.equal(out[2], t_dxtr)
    # without extra: the old outputs only
    assert len(node_round_bwd_plain(tdv, tv, tagg, m)) == 3
    # a zero extra recomputes other ReLU masks: the check must see it
    zero = node_round_bwd_plain(tdv, tv, tagg, m, torch.zeros((n, latent)))
    assert _rel_l2(zero[3].float().numpy(), ref[2]) > 5e-2
    assert _rel_l2(zero[0].float().numpy(), ref[0]) > 1e-2


# --- fused_process with a tensor node_extra -------------------------------------------

def _fused_case():
    jgraph, tgraph, plan, n_real = multi_case()
    L = 16
    rng = np.random.default_rng(11)
    mesh_j, mesh_t = jgraph.edge_sets[0], tgraph.edge_sets[0]
    n_pad, e_pad = jgraph.node_features.shape[0], mesh_j.features.shape[0]
    one = lambda key, d: jax.tree.map(lambda x: np.asarray(x)[None], jax_init_mlp(
        jax.random.PRNGKey(key), d, L, 2, L, layer_norm=True))
    proc = {"edge_mlp": one(1, 3 * L), "node_mlp": one(2, 2 * L)}
    node_mask = np.asarray(jgraph.node_mask)[:, None]
    edge_mask = np.asarray(mesh_j.mask)[:, None]
    v0 = (rng.normal(size=(n_pad, L)) * node_mask).astype(np.float32)
    e0 = (rng.normal(size=(e_pad, L)) * edge_mask).astype(np.float32)
    extra = (rng.normal(size=(n_pad, L)) * node_mask).astype(np.float32)
    cv = (rng.normal(size=(n_pad, L)) * node_mask).astype(np.float32)
    ce = (rng.normal(size=(e_pad, L)) * edge_mask).astype(np.float32)
    return dict(jgraph=jgraph, tgraph=tgraph, plan=plan, proc=proc, v0=v0, e0=e0, extra=extra,
                cv=cv, ce=ce)


def test_fused_process_node_extra_tensor_gradient_matches_jax():
    """The gradient of (v, e) after one round with respect to the
    parameters, v0, e0 and node_extra, against jax.grad of the JAX package's
    fused_process with its kernel backward (interpret mode)."""
    c = _fused_case()
    mesh_j, mesh_t = c["jgraph"].edge_sets[0], c["tgraph"].edge_sets[0]

    def jloss(proc, v0, e0, extra):
        v, e = jax_fused_process(proc, v0, e0, c["plan"], mesh_j.senders, mesh_j.receivers,
                                 mesh_j.mask.astype(jnp.float32)[:, None], 1, interpret=True,
                                 kernel_bwd=True, return_edges=True, node_extra=extra)
        return jnp.sum(v * c["cv"]) + jnp.sum(e * c["ce"])

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jax.tree.map(jnp.asarray, c["proc"]), *(jnp.asarray(c[k]) for k in ("v0", "e0", "extra")))
    proc = _requires_grad(params_from_jax(c["proc"]))
    v0, e0, extra = (torch.from_numpy(c[k]).requires_grad_(True) for k in ("v0", "e0", "extra"))
    v, e = fused_process(proc, v0, e0, mesh_t.senders, mesh_t.receivers, mesh_t.row_offsets,
                         mesh_t.mask.float()[:, None], 1, return_edges=True,
                         sender_perm=mesh_t.sender_perm, sender_offsets=mesh_t.sender_offsets,
                         node_extra=extra)
    loss = (v * torch.from_numpy(c["cv"])).sum() + (e * torch.from_numpy(c["ce"])).sum()
    leaves = param_leaves(proc)
    got = torch.autograd.grad(loss, [*leaves, v0, e0, extra])
    ref = [*jax.tree.leaves(jgrads[0]), *jgrads[1:]]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL, err_msg=str(i))
    assert float(got[-1].abs().max()) > 0  # node_extra's gradient (K5's dxtr)


def test_fused_process_node_extra_tensor_takes_one_round():
    c = _fused_case()
    mesh_t = c["tgraph"].edge_sets[0]
    proc = params_from_jax(jax.tree.map(lambda x: np.concatenate([x, x]), c["proc"]))
    with pytest.raises(ValueError, match="mps=1"):
        fused_process(proc, torch.from_numpy(c["v0"]), torch.from_numpy(c["e0"]),
                      mesh_t.senders, mesh_t.receivers, mesh_t.row_offsets,
                      mesh_t.mask.float()[:, None], 2, node_extra=torch.from_numpy(c["extra"]))


def test_fused_process_node_extra_tensor_forward_is_the_hooks():
    """Without a gradient the tensor form runs the hook form's forward."""
    c = _fused_case()
    mesh_t = c["tgraph"].edge_sets[0]
    proc = params_from_jax(c["proc"])
    args = (proc, torch.from_numpy(c["v0"]), torch.from_numpy(c["e0"]), mesh_t.senders,
            mesh_t.receivers, mesh_t.row_offsets, mesh_t.mask.float()[:, None], 1)
    extra = torch.from_numpy(c["extra"])
    a = fused_process(*args, return_edges=True, node_extra=extra)
    b = fused_process(*args, return_edges=True, node_extra=lambda r, v: extra)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --- the two-edge-set model's gradient ------------------------------------------------

@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("jax_route", ["xla", "fused"])
def test_apply_mgn_multi_gradient_matches_jax(jax_route):
    jgraph, tgraph, plan, n_real = multi_case()
    base = dict(node_input_dim=10, edge_input_dims=(3, 4), output_dim=3, latent_size=16,
                hidden_layers=1, message_passing_steps=2)
    jp = jax_init_mgn_multi(jax.random.PRNGKey(1), JaxMultiMGNConfig(**base))
    if jax_route == "fused":
        jcfg, jplan = JaxMultiMGNConfig(**base, fused=True, fused_backward=True), plan
    else:
        jcfg, jplan = JaxMultiMGNConfig(**base, aggregation_backend="xla"), None

    def jloss(p):
        out = jax_apply_mgn_multi(p, jgraph, jcfg, fused_plan=jplan)
        return jnp.sum(out[:n_real] ** 2)

    ref = jax.grad(jloss)(jp)
    params = _requires_grad(params_from_jax(_np(jp)))
    out = apply_mgn_multi(params, tgraph, MultiMGNConfig(**base))
    got = torch.autograd.grad((out[:n_real] ** 2).sum(), param_leaves(params))
    with torch.no_grad():  # serving's round structure computes the same forward
        assert torch.equal(apply_mgn_multi(params, tgraph, MultiMGNConfig(**base)), out)
    jleaves = jax.tree.leaves(ref)
    assert len(got) == len(jleaves)
    for i, (a, b) in enumerate(zip(got, jleaves)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL, err_msg=str(i))
    # the leaves the world set alone feeds get a gradient (through K5's dxtr
    # in the port): its encoder, its edge MLP and the node MLP's world rows
    grads = dict(zip(map(id, param_leaves(params)), got))
    world = param_leaves([params["edge_encoders"][1], params["processor"]["edge_mlps"][1]])
    for t in world:
        assert float(grads[id(t)].abs().max()) > 0
    w0 = params["processor"]["node_mlp"]["w"][0]
    assert float(grads[id(w0)][:, 32:].abs().max()) > 0  # rows 2L:3L of W0


# --- the K1-backed gather -------------------------------------------------------------

def test_gather_ordered_is_index_select_with_its_gradient():
    rng = np.random.default_rng(3)
    n, cap = 30, 200
    idx = torch.from_numpy(rng.integers(0, n, cap).astype(np.int32))
    valid = torch.from_numpy(rng.random(cap) < 0.7)
    idx = torch.where(valid, idx, torch.zeros_like(idx))  # dead slots point at node 0
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)).requires_grad_(True)
    cot = torch.from_numpy(rng.normal(size=(cap, 8)).astype(np.float32)) * valid[:, None]
    out = gather_ordered(x, idx, *csr_order(idx, n, valid))
    ref = x.index_select(0, idx)
    assert torch.equal(out, ref)
    g, = torch.autograd.grad((out * cot).sum(), x)
    g_ref, = torch.autograd.grad((ref * cot).sum(), x)
    torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-6)
    assert g.dtype == x.dtype


# --- the trainer --------------------------------------------------------------------

def test_make_cloth_trainer_matches_jax():
    """4 steps from identical parameters, noise 0, norm_steps 2 (two warm-up
    steps, then two Adam updates): losses, parameters, every normalizer's
    accumulations (the world set's included) and Adam's moments."""
    pos, cells, nt = make_flag_mesh(12, 8)
    T = 6
    wp = make_flag_trajectory(pos, nt, tl=T, dt=0.02, seed=3)
    meta = flag_meta(T, 1, 1)
    jt = jax_build_template(pos, nt, cells=cells)
    wp_pad = np.zeros((T, jt.num_nodes, 3), np.float32)
    wp_pad[:, : len(pos)] = wp
    times = (np.arange(T) * 0.02).astype(np.float32)
    perm = [3, 1, 4, 2]
    mcfg = jax_cloth_model_config(meta, latent=16, hidden_layers=1, mps=2)
    jcfg = JaxClothConfig(model=mcfg, world_radius=0.3, world_capacity=256, noise_stddev=0.0,
                          norm_steps=2)
    opt = optax.adam(LR)
    jp = jax_init_mgn_multi(jax.random.PRNGKey(0), mcfg)
    jstate = JaxTrainState(params=jp, opt_state=opt.init(jp), norm=jax_make_cloth_norm_state(jcfg),
                           step=jnp.zeros((), jnp.int32))
    jst, jlosses = jax.jit(jax_make_cloth_trainer(jcfg, opt))(
        jstate, jt, jnp.asarray(wp_pad), jnp.asarray(times), jnp.asarray(perm, jnp.int32),
        jax.random.PRNGKey(0))

    cfg = ClothConfig(model=cloth_model_config(meta, latent=16, hidden_layers=1, mps=2),
                      world_radius=0.3, world_capacity=256, noise_stddev=0.0, norm_steps=2)
    params = _requires_grad(params_from_jax(_np(jp)))
    state = TrainState(params, _adam(param_leaves(params)), norm_from_jax(_np(jstate.norm)), 0)
    state, losses = make_cloth_trainer(cfg)(state, build_template(pos, nt, cells=cells),
                                            torch.from_numpy(wp_pad), torch.from_numpy(times),
                                            perm, torch.Generator().manual_seed(0))
    assert state.step == int(jst.step) == 4
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    got, ref = param_leaves(state.params), jax.tree.leaves(jst.params)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    norms = [(state.norm.edge[k], jst.norm.edge[k]) for k in ("mesh", "world")]
    norms += [(state.norm.node["velocity"], jst.norm.node["velocity"]),
              (state.norm.output["acceleration"], jst.norm.output["acceleration"])]
    for a, b in norms:
        for f in ("acc_sum", "acc_sum_sq", "num_accumulations", "acc_count"):
            np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    assert float(state.norm.edge["world"].num_accumulations) > 0  # world edges were there
    ours = state.optimizer.state_dict()["state"]
    theirs = adam_state_from_jax(_np(jst.opt_state))
    assert float(ours[0]["step"]) == float(theirs[0]["step"]) == 2.0
    for i in theirs:
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(ours[i][k], theirs[i][k], rtol=1e-4, atol=1e-6)


# --- the dataset and train_network ------------------------------------------------------

@pytest.fixture(scope="module")
def flag_ds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("flag_ds"))
    write_flag_tfrecord_dataset(d, **FLAG_DS)
    return d


def test_jax_reads_the_port_flag_tfrecord_as_its_hdf5(flag_ds, tmp_path):
    h5 = str(tmp_path / "h5")
    jax_write_flag_dataset(h5, **FLAG_DS)
    for valid in (False, True):
        a, b = jax_load_dataset(flag_ds), jax_load_dataset(h5)
        n = a.num_valid if valid else a.num_trajectories
        assert n == (b.num_valid if valid else b.num_trajectories) > 0
        for i in range(n):
            ta, tb = a.trajectory(i, valid=valid), b.trajectory(i, valid=valid)
            for f in ("mesh_pos", "node_type", "cells"):
                assert np.array_equal(np.asarray(getattr(ta, f)), np.asarray(getattr(tb, f))), f
            assert np.array_equal(ta.fields["world_pos"], tb.fields["world_pos"])
    with open(f"{flag_ds}/meta.json") as f:
        assert json.load(f)["world_edges"] == {"radius": 0.05, "capacity_per_node": 4}


@pytest.fixture(scope="module")
def jax_flag_run(flag_ds, tmp_path_factory):
    """mgn_tpu.train_network on the flag dataset, 10 steps from scratch (two
    5-frame windows, norm_steps 3, a checkpoint and a validation sweep after
    each window)."""
    cp = str(tmp_path_factory.mktemp("cp_jax_flag"))
    log = io.StringIO()
    state, best = jax_train_network(0.0, optax.adam(LR), flag_ds, cp,
                                    metrics=JaxMetricsLogger(stream=log), steps=10, **RUN)
    return dict(state=state, best=best, log=log)


def _records(stream, kind):
    return [r for r in map(json.loads, stream.getvalue().splitlines()) if r["kind"] == kind]


def test_cloth_train_network_visits_the_same_frames_as_jax(flag_ds, jax_flag_run, tmp_path):
    """Started from the JAX package's initial cloth state (converted), the
    port's train_network draws the same frames and reaches the same losses,
    validation losses, best loss and parameters."""
    ds = jax_load_dataset(flag_ds)
    jstate0, _, _ = jax_init_cloth_state(ds.meta, JaxArgs(**RUN).resolve_auto(), optax.adam(LR))
    cp = str(tmp_path / "cp")
    save_train_state_from_jax(_np(jstate0), cp)
    log = MetricsLogger(quiet=True)
    state, best = mgn_tpu_torch.train_network(0.0, _adam, flag_ds, cp, metrics=log,
                                              device="cpu", steps=10, **RUN)
    ref = _records(jax_flag_run["log"], "train")
    got = [r for r in log.records if r["kind"] == "train"]
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [5, 10]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], **TOL)
    ref_valid = _records(jax_flag_run["log"], "valid")
    got_valid = [r for r in log.records if r["kind"] == "valid"]
    assert len(got_valid) == len(ref_valid) == 2
    np.testing.assert_allclose([r["loss"] for r in got_valid],
                               [r["loss"] for r in ref_valid], **TOL)
    np.testing.assert_allclose(best, jax_flag_run["best"], **TOL)
    # Parameters: elementwise within TOL, except in the two leaves groups fed
    # by the world edges' features.  On this regular sheet every world edge is
    # a cell's other diagonal, so |x_ij| has std 0.00096 about a mean of
    # 0.0478: the Online normalizer's f32 E[x^2] - E[x]^2 cancels and the two
    # packages' sums (in another order) give stds apart in the fourth digit.
    # Seven Adam updates carry that into the world set's near-zero gradient
    # entries; there at most 1 % of a leaf's entries may lie outside TOL, with
    # relative L2 <= 1e-3.
    ref_state = jax_flag_run["state"]
    std = [float(n.std[-1]) for n in (state.norm.edge["world"], ref_state.norm.edge["world"])]
    assert std[0] < 0.05 * float(state.norm.edge["world"].mean[-1]), std
    world = {id(t) for t in param_leaves([state.params["edge_encoders"][1],
                                          state.params["processor"]["edge_mlps"][1]])}
    got_p, ref_p = param_leaves(state.params), jax.tree.leaves(ref_state.params)
    assert len(got_p) == len(ref_p)
    for t, b in zip(got_p, ref_p):
        a, b = t.detach().numpy(), np.asarray(b)
        if id(t) not in world:
            np.testing.assert_allclose(a, b, **TOL)
            continue
        outside = np.abs(a - b) > TOL["atol"] + TOL["rtol"] * np.abs(b)
        assert outside.mean() <= 0.01 and _rel_l2(a, b) <= 1e-3, (outside.sum(), _rel_l2(a, b))
    assert float(state.norm.edge["world"].num_accumulations) > 0


def test_cloth_resume_k_plus_k_equals_2k(flag_ds, tmp_path):
    """With noise: the resumed run draws the windows and the noise an
    uninterrupted one draws (the host state from host.json)."""
    noise = 3e-3
    once, _ = mgn_tpu_torch.train_network(noise, _adam, flag_ds, str(tmp_path / "a"),
                                          device="cpu", steps=10, **RUN)
    mgn_tpu_torch.train_network(noise, _adam, flag_ds, str(tmp_path / "b"), device="cpu",
                                steps=5, **RUN)
    log = MetricsLogger(quiet=True)
    twice, _ = mgn_tpu_torch.train_network(noise, _adam, flag_ds, str(tmp_path / "b"),
                                           metrics=log, device="cpu", steps=10, **RUN)
    assert [r["step"] for r in log.records if r["kind"] == "resume"] == [5]
    assert twice.step == once.step == 10
    for a, b in zip(param_leaves(twice.params), param_leaves(once.params)):
        assert torch.equal(a, b)
    sa, sb = twice.optimizer.state_dict()["state"], once.optimizer.state_dict()["state"]
    for i in sa:
        assert torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])
    for k in ("mesh", "world"):
        assert torch.equal(twice.norm.edge[k].acc_sum, once.norm.edge[k].acc_sum)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(training_strategy=SolverTraining(tstart=0.0, dt=0.02, tstop=0.1)), ValueError,
     "DerivativeTraining"),
    # graph-parallel cloth training runs under a process group of graph_parallel ranks
    (dict(graph_parallel=2), ValueError, "torchrun"),
])
def test_cloth_train_network_refuses(flag_ds, tmp_path, kwargs, error, match):
    with pytest.raises(error, match=match):
        mgn_tpu_torch.train_network(0.0, _adam, flag_ds, str(tmp_path), device="cpu", steps=5,
                                    **{**RUN, **kwargs})
