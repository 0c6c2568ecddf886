"""Port: latent widths the kernels are not built for (any width up to 256
that is not 32, 64, 128 or 256), on the CPU.  ``fused_process`` pads such a
processor to ``kernel_width(L)`` on every device and runs the card's route
with the kernels' plain versions in their place: the processor, its
gradient, the padded columns' zeros, ``simulate``, a derivative training
step, an artefact, the cloth family and graph parallelism at such widths,
against the JAX package (which runs any width) and the port's own
references.  Inputs come from numpy seeds."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import init_state as jax_init_state
from mgn_tpu.api import simulate as jax_simulate
from mgn_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.prep import common_buckets as jax_common_buckets
from mgn_tpu.data.prep import prepare_trajectory as jax_prepare_trajectory
from mgn_tpu.data.synthetic import make_channel_mesh, make_trajectory, synthetic_meta
from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.models.mgn_multi import MultiMGNConfig as JaxMultiMGNConfig
from mgn_tpu.models.mgn_multi import apply_mgn_multi as jax_apply_mgn_multi
from mgn_tpu.models.mgn_multi import init_mgn_multi as jax_init_mgn_multi
from mgn_tpu.ops.fused import build_fused_plan, fused_process as jax_fused_process
from mgn_tpu.ops.fused import process_rounds_xla
from mgn_tpu.train.cloth import ClothConfig as JaxClothConfig
from mgn_tpu.train.cloth import cloth_model_config as jax_cloth_model_config
from mgn_tpu.train.cloth import make_cloth_norm_state as jax_make_cloth_norm_state
from mgn_tpu.train.cloth import make_cloth_trainer as jax_make_cloth_trainer
from mgn_tpu.train.common import TrainState as JaxTrainState
from mgn_tpu.train.derivative import DerivativeTrainerConfig as JaxTrainerConfig
from mgn_tpu.train.derivative import make_derivative_trainer as jax_make_trainer
import mgn_tpu_torch
from mgn_tpu_torch.api import build_model_config
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax, save_checkpoint_from_jax
from mgn_tpu_torch.core.graph import MeshGraph, build_template, sender_csr
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.prep import prepare_trajectory
from mgn_tpu_torch.data.synthetic import (flag_meta, make_flag_mesh, make_flag_trajectory,
                                          write_synthetic_tfrecord_dataset)
from mgn_tpu_torch.models.mgn import MGNConfig, apply_mgn
from mgn_tpu_torch.models.mgn_multi import MultiMGNConfig, apply_mgn_multi
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops import library as L
from mgn_tpu_torch.parallel.mesh import spawn
from mgn_tpu_torch.parallel.partition import global_ids
from mgn_tpu_torch.serve import export_simulator, load_simulator
from mgn_tpu_torch.train.cloth import ClothConfig, cloth_model_config, make_cloth_trainer
from mgn_tpu_torch.train.common import TrainState, param_leaves
from mgn_tpu_torch.train.derivative import DerivativeTrainerConfig, make_derivative_trainer
from tests import torch_parallel_support as S
from tests.test_torch_cloth import multi_case
from tests.torch_support import local_graph, one_thread  # noqa: F401  (fixture)

torch.set_num_threads(2)

N, E, MPS = 256, 512, 3
F32_TOL = dict(rtol=2e-5, atol=2e-5)  # test_torch_fused.py's f32 tolerance
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)  # test_torch_fused_grad.py's
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _processor_case(seed, latent, hidden=2, dead_edges=0, perturb=False):
    """A random processor of width ``latent`` (JAX's init; with ``perturb``
    non-trivial biases and LayerNorm parameters) and inputs on a local
    graph of N nodes and E receiver-sorted edges, the last ``dead_edges``
    of them dead and aimed at the trash node; numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    s, r = local_graph(rng, N, E)
    if dead_edges:
        s[-dead_edges:] = N - 1
        r[-dead_edges:] = N - 1
    cfg = JaxMGNConfig(node_input_dim=8, edge_input_dim=3, output_dim=2, latent_size=latent,
                       hidden_layers=hidden, message_passing_steps=MPS)
    proc = jax_init_mgn(jax.random.PRNGKey(seed), cfg)["processor"]
    if perturb:
        proc = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype),
                            proc)
    v0 = rng.normal(size=(N, latent)).astype(np.float32)
    e0 = rng.normal(size=(E, latent)).astype(np.float32)
    ev = np.ones((E, 1), np.float32)
    if dead_edges:
        ev[-dead_edges:] = 0.0
        e0[-dead_edges:] = 0.0
    row = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=N))]).astype(np.int32)
    perm, offsets = sender_csr(s, N)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    port = dict(proc=params_from_jax(_np(proc)), v0=t(v0), e0=t(e0), s=t(s), r=t(r),
                row=t(row), ev=t(ev), perm=t(perm), offsets=t(offsets))
    return dict(proc=proc, s=s, r=r, v0=v0, e0=e0, ev=ev, port=port)


def _fused(port, dtype=torch.float32, **kw):
    return F.fused_process(port["proc"], port["v0"].to(dtype), port["e0"].to(dtype), port["s"],
                           port["r"], port["row"], port["ev"].to(dtype), MPS, **kw)


# --- the width the kernels run -------------------------------------------------------

@pytest.mark.parametrize("latent,tile", [(1, 32), (31, 32), (32, 32), (48, 64), (90, 128),
                                         (129, 256), (200, 256), (256, 256)])
def test_kernel_width_is_the_narrowest_built_tile(latent, tile):
    assert F.kernel_width(latent) == F.kernel_width(latent, "cpu") == tile


def test_kernel_width_refuses_wider_than_256_on_cuda():
    """Above 256 the card's route raises, naming the roadmap item; the
    CPU's plain versions take any width (no padding)."""
    for device in ("cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="A8.2"):
            F.kernel_width(257, device)
    assert F.kernel_width(300, "cpu") == 300
    with pytest.raises(ValueError):
        F.kernel_width(0, "cpu")


# --- the processor -------------------------------------------------------------------

@pytest.mark.parametrize("latent", [48, 90, 200])
@pytest.mark.parametrize("hidden", [1, 2])
def test_fused_process_matches_the_jax_kernel(latent, hidden):
    """f32, no dead edges: the padded route against the JAX fused kernel in
    interpret mode at the real width, 2e-5."""
    c = _processor_case(1, latent, hidden)
    plan = build_fused_plan(c["s"], c["r"], N)
    assert plan is not None
    ref = jax_fused_process(c["proc"], jnp.asarray(c["v0"]), jnp.asarray(c["e0"]), plan,
                            jnp.asarray(c["s"]), jnp.asarray(c["r"]), jnp.asarray(c["ev"]), MPS,
                            interpret=True)
    out = _fused(c["port"])
    assert tuple(out.shape) == (N, latent) and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def _xla(c, jdt, return_edges=True):
    return process_rounds_xla(c["proc"], jnp.asarray(c["v0"]).astype(jdt),
                              jnp.asarray(c["e0"]).astype(jdt), jnp.asarray(c["s"]),
                              jnp.asarray(c["r"]), jnp.asarray(c["ev"]).astype(jdt), MPS, jdt,
                              N, return_edges=return_edges)


@pytest.mark.parametrize("latent", [48, 90, 200])
def test_fused_process_with_dead_edges_matches_xla(latent):
    """f32 with 40 dead edges (the JAX fused forward does not mask them,
    ROADMAP C2): against process_rounds_xla, 2e-5; the dead edges' ``e``
    stays 0."""
    c = _processor_case(2, latent, dead_edges=40)
    ref_v, ref_e = _xla(c, jnp.float32)
    v, e = _fused(c["port"], return_edges=True)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), **F32_TOL)
    np.testing.assert_allclose(e.numpy(), np.asarray(ref_e), **F32_TOL)
    assert not e.numpy()[-40:].any()


@pytest.mark.parametrize("latent", [48, 90, 200])
def test_fused_process_bf16_matches_xla(latent):
    """bf16 inputs on both sides, against process_rounds_xla at
    test_torch_fused.py's bf16 tolerance: relative L2 <= 2e-2 and every
    entry within 2^-5 x max |ref| (the reference sums messages in bf16,
    the port in f32, ROADMAP C1)."""
    c = _processor_case(2, latent, dead_edges=40)
    for got, ref in zip(_fused(c["port"], torch.bfloat16, return_edges=True),
                        _xla(c, jnp.bfloat16)):
        got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
        assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
        assert np.abs(got - ref).max() <= 2.0 ** -5 * np.abs(ref).max()


@pytest.mark.parametrize("latent", [48, 90])
def test_fused_process_gradient_matches_jax_grad(latent):
    """The Function's backward on the padded tile (plain K4/K5/K6/K8 on the
    CPU, the defer_first form) against jax.grad of process_rounds_xla at the
    real width, every processor leaf, v0 and e0 (test_torch_fused_grad.py's
    tolerance); the gradients come back at the real shapes."""
    c = _processor_case(3, latent, perturb=True)
    sj, rj, evj = jnp.asarray(c["s"]), jnp.asarray(c["r"]), jnp.asarray(c["ev"])

    def loss(p, v, e_):
        out = process_rounds_xla(p, v, e_, sj, rj, evj, MPS, jnp.float32, N)
        return jnp.sum(out ** 2) + jnp.sum(out[:, 0])

    ref = jax.grad(loss, argnums=(0, 1, 2))(c["proc"], jnp.asarray(c["v0"]), jnp.asarray(c["e0"]))
    ref = jax.tree.leaves(ref[0]) + [ref[1], ref[2]]
    port = c["port"]
    leaves = param_leaves(port["proc"])
    v0, e0 = port["v0"].requires_grad_(True), port["e0"].requires_grad_(True)
    for x in leaves:
        x.requires_grad_(True)
    out = F.fused_process(port["proc"], v0, e0, port["s"], port["r"], port["row"], port["ev"],
                          MPS, sender_perm=port["perm"], sender_offsets=port["offsets"])
    got = torch.autograd.grad((out ** 2).sum() + out[:, 0].sum(), [*leaves, v0, e0])
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert tuple(a.shape) == b.shape, i
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL, err_msg=str(i))


def test_padded_columns_stay_exactly_zero(monkeypatch):
    """L = 90 on the 128 tile: after one forward and backward, every saved
    tensor (v, e, agg, P, Q, the ReLU outputs, xhat) and every cotangent
    (dv, de, dagg, dh0, G_s, G_r, each layer's dh, the LayerNorm partial
    sums) is exactly 0 in columns 90..127, in both backward forms."""
    width, tile = 90, 128
    seen = []

    def pad_of(name, t):
        if isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[-1] in (tile, 2 * tile):
            cols = (t[:, width:tile] if t.shape[-1] == tile
                    else torch.cat([t[:, width:tile], t[:, tile + width:]], 1))
            seen.append(name)
            assert not cols.any(), name

    def wrap(name, fn, record):
        def run(*args, **kw):
            out = fn(*args, **kw)
            record(args, out)
            return out
        monkeypatch.setattr(F, name, run)

    def rec_recompute(args, out):
        posts, xhat, _ = out
        for i, p in enumerate(posts):
            pad_of(f"post{i}", p)
        pad_of("xhat", xhat)

    def rec_saved(prefix, saved):
        for i, d in enumerate(saved.dh):
            pad_of(f"{prefix}.dh{i}", d)
        for i, p in enumerate(saved.post):
            pad_of(f"{prefix}.post{i}", p)
        pad_of(f"{prefix}.ln", saved.ln)

    def rec_node_bwd(args, out):
        dv, v, agg = args[:3]
        pad_of("dv", dv)
        pad_of("v", v)
        pad_of("agg", agg)
        pad_of("dagg", out[0])
        rec_saved("node", out[1])

    def rec_edge_bwd(args, out):
        de, dagg, e, p, q = args[:5]
        for name, t in (("de", de), ("e", e), ("P", p), ("Q", q)):
            pad_of(name, t)
        rec_saved("edge", out if isinstance(out, F.MlpSaved) else out[2])
        if not isinstance(out, F.MlpSaved):
            pad_of("dvs", out[0])
            pad_of("dvr", out[1])

    def rec_adjoint(args, out):
        dv, g_s, g_r = args[:3]
        for name, t in (("dv'", dv), ("G_s", g_s), ("G_r", g_r)):
            pad_of(name, t)

    wrap("_mlp_recompute", F._mlp_recompute, rec_recompute)
    wrap("node_round_bwd", F.node_round_bwd, rec_node_bwd)
    wrap("edge_round_bwd", F.edge_round_bwd, rec_edge_bwd)
    wrap("first_layer_adjoint", F.first_layer_adjoint, rec_adjoint)
    c = _processor_case(4, width, perturb=True)
    port = c["port"]
    for defer in (True, False):
        monkeypatch.setattr(F, "_FORCE_DEFER", defer)
        seen.clear()
        leaves = [x.detach().clone().requires_grad_(True) for x in param_leaves(port["proc"])]
        proc = _rebuild(port["proc"], iter(leaves))
        v0 = port["v0"].clone().requires_grad_(True)
        v, e = F.fused_process(proc, v0, port["e0"], port["s"], port["r"], port["row"],
                               port["ev"], MPS, return_edges=True, sender_perm=port["perm"],
                               sender_offsets=port["offsets"])
        grads = torch.autograd.grad((v ** 2).sum() + (e ** 2).sum(), [*leaves, v0])
        want = {"dv", "v", "agg", "dagg", "de", "e", "P", "Q", "xhat", "post0", "node.dh0",
                "node.ln", "edge.dh0", "edge.dh1", "edge.ln"}
        want |= {"G_s", "G_r", "dv'"} if defer else {"dvs", "dvr"}
        assert want <= set(seen), sorted(want - set(seen))
        assert tuple(grads[-1].shape) == (N, width)
        assert all(torch.isfinite(g).all() for g in grads)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


@pytest.mark.usefixtures("one_thread")
def test_built_width_runs_no_pad_and_keeps_the_bits(monkeypatch):
    """At L = 128 the route pads nothing (the pad helpers raise if called)
    and fused_process keeps its bits: the pre-projected plain rounds', as at
    every built width; its gradient runs unpadded too."""
    def refuse(*args, **kw):
        raise AssertionError("a pad op at a built width")

    monkeypatch.setattr(F, "_pad_cols", refuse)
    monkeypatch.setattr(F, "_pad_mlp", refuse)
    c = _processor_case(5, 128, dead_edges=16)
    port = c["port"]
    v, e = _fused(port, return_edges=True)
    ref_v, ref_e = F.process_rounds_plain(port["proc"], port["v0"], port["e0"], port["s"],
                                          port["r"], port["ev"], MPS, torch.float32, N,
                                          return_edges=True, preproject=True)
    assert torch.equal(v, ref_v) and torch.equal(e, ref_e)
    v0 = port["v0"].clone().requires_grad_(True)
    out = F.fused_process(port["proc"], v0, port["e0"], port["s"], port["r"], port["row"],
                          port["ev"], MPS, sender_perm=port["perm"],
                          sender_offsets=port["offsets"])
    assert torch.equal(out.detach(), ref_v)
    (g,) = torch.autograd.grad(out.sum(), [v0])
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("name", ["edge_round", "node_round"])
@pytest.mark.parametrize("width", [32, 20])
def test_opcheck_at_a_real_width(name, width):
    """The operators whose schema carries the real width, at the tile width
    and inside it (the tensors 32 wide, the LayerNorm over ``width``):
    schema, fake shapes and dispatch; the CPU implementation is the plain
    version at that width."""
    from tests.test_torch_serve import _operator_inputs

    args = list(_operator_inputs(name))
    args[-1] = width
    torch.library.opcheck(getattr(torch.ops.mgn_tpu_torch, name).default, tuple(args))
    assert "int width" in L.SCHEMAS[name]


# --- the entry points at width 48 -------------------------------------------------------

SMALL48 = dict(mps=3, layer_size=48, hidden_layers=2)


def _online(norm, x):
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    return norm.replace(acc_count=np.float32(1.0), num_accumulations=np.float32(len(x)),
                        acc_sum=x.sum(0).astype(np.float32),
                        acc_sum_sq=(x * x).sum(0).astype(np.float32))


@pytest.fixture(scope="module")
def serving48(tmp_path_factory):
    """A JAX checkpoint at width 48, converted for the port; the 100-node
    channel mesh's first frame and 5 Euler steps."""
    root = tmp_path_factory.mktemp("width48")
    dt = 0.01
    meta = synthetic_meta(tl=10, n_train=1, n_valid=1, dt=dt)
    with open(root / "meta.json", "w") as f:
        json.dump(meta, f)
    pos, cells, node_type = make_channel_mesh(100, seed=0)
    vel = make_trajectory(pos, node_type, tl=10, dt=dt, seed=5)
    state, _, _ = jax_init_state(meta, JaxArgs(seed=3, **SMALL48), optax.sgd(1.0))
    t = jax_build_template(pos, node_type, cells=cells)
    mef = np.asarray(t.mesh_edge_features)[np.asarray(t.edge_mask)]
    norm = state.norm.replace(
        edge=_online(state.norm.edge, mef),
        node={**state.norm.node, "velocity": _online(state.norm.node["velocity"], vel)},
        output={"velocity": _online(state.norm.output["velocity"], np.diff(vel, axis=0) / dt)})
    state = state.replace(norm=_np(norm))
    jax_cp = str(root / "cp_jax")
    JaxCheckpointManager(jax_cp).save(state, loss=0.0)
    model = JaxCheckpointManager(jax_cp).restore_model(JaxCheckpointManager.model_subtree(state))
    torch_cp = str(root / "cp_torch")
    save_checkpoint_from_jax(_np(model), torch_cp)
    times = (np.arange(6) * dt).astype(np.float32)
    mesh = dict(mesh_pos=pos, node_type=node_type, cells=cells)
    out = mgn_tpu_torch.simulate(str(root), torch_cp, initial_fields={"velocity": vel[0]},
                                 times=times, device="cpu", **mesh, **SMALL48)
    return dict(root=str(root), jax_cp=jax_cp, torch_cp=torch_cp, mesh=mesh, v0=vel[0],
                times=times, out=out)


def test_simulate_at_width_48_matches_jax(serving48):
    c = serving48
    ref = jax_simulate(c["root"], c["jax_cp"], c["mesh"]["mesh_pos"], c["mesh"]["node_type"],
                       {"velocity": c["v0"]}, c["times"], cells=c["mesh"]["cells"], **SMALL48)
    out = c["out"]
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out[-1] - out[0]).max() > 1e-3
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_artefact_at_width_48_gives_simulate_bits(serving48):
    c = serving48
    blob = export_simulator(c["root"], c["torch_cp"], num_steps=len(c["times"]), device="cpu",
                            **c["mesh"], **SMALL48)
    out = load_simulator(blob, device="cpu")(c["times"], c["v0"])
    assert np.array_equal(out, c["out"])


def test_derivative_step_at_width_48_matches_jax(tmp_path):
    """3 noise-free steps from identical parameters, norm_steps 2 (two
    warm-up steps, then one Adam update): losses and parameters within 1e-4
    of the JAX trainer's."""
    ds = str(tmp_path / "ds")
    write_synthetic_tfrecord_dataset(ds, num_nodes=60, tl=6, n_train=1, n_valid=1, n_test=0)
    jds = jax_load_dataset(ds)
    meta = jds.meta
    small = dict(mps=2, layer_size=48, hidden_layers=1)
    opt = optax.adam(1e-3)
    jstate, jcfg, jspec = jax_init_state(meta, JaxArgs(seed=0, norm_steps=2, **small)
                                         .resolve_auto(), opt)
    nb, eb = jax_common_buckets([jds.trajectory(0)], meta)
    jprep = jax_prepare_trajectory(jds.trajectory(0), meta, jspec, nb, eb)
    perm = [3, 0, 2]
    jtrain = jax.jit(jax_make_trainer(
        JaxTrainerConfig(model=jcfg, spec=jspec, noise_stddevs=(0.0,), norm_steps=2), opt))
    jst, jlosses = jtrain(jstate, jprep.template, jprep.fields, jprep.times,
                          jnp.asarray(perm, jnp.int32), jax.random.PRNGKey(0))
    cfg, spec = build_model_config(meta, Args(**small))
    params = params_from_jax(_np(jstate.params))
    for p in param_leaves(params):
        p.requires_grad_(True)
    state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=1e-3),
                       norm_from_jax(_np(jstate.norm)), 0)
    prep = prepare_trajectory(load_dataset(ds).trajectory(0), meta, spec, nb, eb)
    train = make_derivative_trainer(DerivativeTrainerConfig(cfg, spec, (0.0,), norm_steps=2))
    state, losses = train(state, prep.template, prep.fields, prep.times, perm,
                          torch.Generator().manual_seed(0))
    assert state.step == int(jst.step) == 3
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    got, ref = param_leaves(state.params), jax.tree.leaves(jst.params)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


# --- the cloth family at width 90 -------------------------------------------------------

CLOTH90 = dict(node_input_dim=10, edge_input_dims=(3, 4), output_dim=3, latent_size=90,
               hidden_layers=1, message_passing_steps=2)


@pytest.mark.usefixtures("one_thread")
def test_cloth_forward_and_gradient_at_width_90_match_jax():
    """apply_mgn_multi at L = 90 (serving's hook route under no_grad, the
    tensor route with a gradient) against JAX's apply_mgn_multi (XLA route):
    the forward within 1e-4 and every leaf's gradient within the cloth
    tests' fused-gradient tolerance (rtol 2e-3, atol 2e-4)."""
    jgraph, tgraph, _, n_real = multi_case()
    jcfg = JaxMultiMGNConfig(**CLOTH90, aggregation_backend="xla")
    jp = jax_init_mgn_multi(jax.random.PRNGKey(1), jcfg)
    ref_out = np.asarray(jax_apply_mgn_multi(jp, jgraph, jcfg))
    ref = jax.tree.leaves(jax.grad(
        lambda p: jnp.sum(jax_apply_mgn_multi(p, jgraph, jcfg)[:n_real] ** 2))(jp))
    params = params_from_jax(_np(jp))
    with torch.no_grad():
        served = apply_mgn_multi(params, tgraph, MultiMGNConfig(**CLOTH90))
    np.testing.assert_allclose(served.numpy()[:n_real], ref_out[:n_real], **TOL)
    for t in param_leaves(params):
        t.requires_grad_(True)
    out = apply_mgn_multi(params, tgraph, MultiMGNConfig(**CLOTH90))
    assert torch.equal(out.detach(), served)
    got = torch.autograd.grad((out[:n_real] ** 2).sum(), param_leaves(params))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-4,
                                   err_msg=str(i))


def test_cloth_training_step_at_width_90_matches_jax():
    """3 noise-free cloth trainer steps at L = 90 (two warm-up steps, one
    Adam update) from identical parameters: losses and parameters within
    1e-4 of JAX's make_cloth_trainer."""
    pos, cells, nt = make_flag_mesh(12, 8)
    T = 5
    wp = make_flag_trajectory(pos, nt, tl=T, dt=0.02, seed=3)
    meta = flag_meta(T, 1, 1)
    jt = jax_build_template(pos, nt, cells=cells)
    wp_pad = np.zeros((T, jt.num_nodes, 3), np.float32)
    wp_pad[:, :len(pos)] = wp
    times = (np.arange(T) * 0.02).astype(np.float32)
    perm = [2, 1, 0]
    mcfg = jax_cloth_model_config(meta, latent=90, hidden_layers=1, mps=2)
    jcfg = JaxClothConfig(model=mcfg, world_radius=0.3, world_capacity=256, noise_stddev=0.0,
                          norm_steps=2)
    opt = optax.adam(1e-3)
    jp = jax_init_mgn_multi(jax.random.PRNGKey(0), mcfg)
    jstate = JaxTrainState(params=jp, opt_state=opt.init(jp),
                           norm=jax_make_cloth_norm_state(jcfg), step=jnp.zeros((), jnp.int32))
    jst, jlosses = jax.jit(jax_make_cloth_trainer(jcfg, opt))(
        jstate, jt, jnp.asarray(wp_pad), jnp.asarray(times), jnp.asarray(perm, jnp.int32),
        jax.random.PRNGKey(0))
    cfg = ClothConfig(model=cloth_model_config(meta, latent=90, hidden_layers=1, mps=2),
                      world_radius=0.3, world_capacity=256, noise_stddev=0.0, norm_steps=2)
    params = params_from_jax(_np(jp))
    for t in param_leaves(params):
        t.requires_grad_(True)
    state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=1e-3),
                       norm_from_jax(_np(jstate.norm)), 0)
    state, losses = make_cloth_trainer(cfg)(state, build_template(pos, nt, cells=cells),
                                            torch.from_numpy(wp_pad), torch.from_numpy(times),
                                            perm, torch.Generator().manual_seed(0))
    assert state.step == int(jst.step) == 3
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    for a, b in zip(param_leaves(state.params), jax.tree.leaves(jst.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


# --- graph parallelism at width 48 ------------------------------------------------------

def test_graph_parallel_at_width_48_matches_the_single_device():
    """Mesh (1, 2) over gloo at L = 48 (tests/torch_parallel_support.width_rank):
    the deep and the classic exchange's outputs, un-permuted, against the
    single device (1e-5), and every leaf's world-summed gradient, the same
    on both ranks, within rtol 1e-4 and atol 1e-5 of the single device's
    (the parts add the f32 terms of each weight's sum in another order than
    one device; at width 16, test_torch_parallel.py's atol 1e-6 holds)."""
    latent = 48
    pb = S.problem()
    cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=latent,
                    hidden_layers=S.HIDDEN, message_passing_steps=S.MPS)
    jcfg = JaxMGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=latent,
                        hidden_layers=S.HIDDEN, message_passing_steps=S.MPS)
    params = params_from_jax(_np(jax_init_mgn(jax.random.PRNGKey(0), jcfg)))
    ranks = spawn(2, S.width_rank, (params, pb, latent))
    t = build_template(pb["pos"], pb["nt"], cells=pb["cells"])
    n = len(pb["pos"])
    nf = np.zeros((t.num_nodes, 9), np.float32)
    nf[:n] = pb["nf"]
    w = np.zeros((t.num_nodes, 2), np.float32)
    w[:n] = pb["w"]
    g = MeshGraph(torch.as_tensor(nf), t.mesh_edge_features * t.edge_mask[:, None], t.senders,
                  t.receivers, t.node_mask, t.edge_mask)
    leaves = [x.detach().clone().requires_grad_(True) for x in param_leaves(params)]
    out = apply_mgn(_rebuild(params, iter(leaves)), g, cfg, t.row_offsets, t.sender_perm,
                    t.sender_offsets)
    ref = torch.autograd.grad((out * torch.as_tensor(w)).sum(), leaves)
    ref_flat = np.concatenate([x.numpy().reshape(-1) for x in ref])
    for form in ("deep4", "halo"):
        got = np.stack([r[form][0] for r in ranks])
        pt = S.planned(pb, form)
        flat = got.reshape(-1, 2)[global_ids(pt, n)]
        np.testing.assert_allclose(flat, out.detach().numpy()[:n], rtol=1e-5, atol=1e-5)
        g0, g1 = ranks[0][form][1][0], ranks[1][form][1][0]
        np.testing.assert_array_equal(g0, g1)
        np.testing.assert_allclose(g0, ref_flat, rtol=1e-4, atol=1e-5)
