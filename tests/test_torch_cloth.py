"""Port: the cloth / world-edge family (FlagSimple) — world edges, the
unsorted segment sum, K3's node_extra form (plain version), the
multi-edge-set model, the cloth rollout and the cloth simulator — against
the JAX package on the CPU.

World-edge sets may differ from the JAX package's only at radius ties: a
pair whose exact squared distance lies within 1e-6 * max(r^2, 1) of r^2,
where the two packages' f32 sums can fall on either side (and, where the
buffer is full, the pairs a tie pushes past its end)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.core import normalizers as JN
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.core.graph import build_world_edges as jax_build_world_edges
from mgn_tpu.data.synthetic import make_flag_mesh as jax_make_flag_mesh
from mgn_tpu.data.synthetic import make_flag_trajectory as jax_make_flag_trajectory
from mgn_tpu.models.mgn_multi import EdgeSet as JaxEdgeSet
from mgn_tpu.models.mgn_multi import MultiGraph as JaxMultiGraph
from mgn_tpu.models.mgn_multi import MultiMGNConfig as JaxMultiMGNConfig
from mgn_tpu.models.mgn_multi import apply_mgn_multi as jax_apply_mgn_multi
from mgn_tpu.models.mgn_multi import init_mgn_multi as jax_init_mgn_multi
from mgn_tpu.models.mlp import apply_mlp_parts as jax_apply_mlp_parts
from mgn_tpu.models.mlp import init_mlp as jax_init_mlp
from mgn_tpu.ops.fused import build_fused_plan
from mgn_tpu.train.cloth import ClothConfig as JaxClothConfig
from mgn_tpu.train.cloth import cloth_model_config as jax_cloth_model_config
from mgn_tpu.train.cloth import make_cloth_norm_state as jax_make_cloth_norm_state
from mgn_tpu.train.cloth import make_cloth_rollout as jax_make_cloth_rollout
from mgn_tpu.train.common import NormState as JaxNormState
from mgn_tpu_torch import cloth_simulator
from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax
from mgn_tpu_torch.core import normalizers as TN
from mgn_tpu_torch.core.graph import build_template, build_world_edges
from mgn_tpu_torch.data.synthetic import (flag_meta, make_channel_mesh, make_flag_mesh,
                                          make_flag_trajectory)
from mgn_tpu_torch.models.mgn_multi import (EdgeSet, MultiGraph, MultiMGNConfig,
                                            apply_mgn_multi, init_mgn_multi)
from mgn_tpu_torch.ops.fused import fused_process, node_round, node_round_plain
from mgn_tpu_torch.ops.segment import segment_sum
from mgn_tpu_torch.train.cloth import (ClothConfig, cloth_model_config, make_cloth_norm_state,
                                       make_cloth_rollout)
from mgn_tpu_torch.train.common import NormState, TrainState

torch.set_num_threads(2)

TIE = 1e-6  # relative width of the radius-tie band


# --- world edges -------------------------------------------------------------------

def tie_pairs(pos, mask, radius, exclude=None):
    """Flat indices s * n + r of the valid, distinct, non-excluded pairs whose
    exact (f64) squared distance lies within the tie band of radius^2."""
    p = np.asarray(pos, np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    r2 = radius * radius
    near = np.abs(d2 - r2) <= TIE * max(r2, 1.0)
    near &= mask[:, None] & mask[None, :]
    np.fill_diagonal(near, False)
    if exclude is not None:
        near[exclude[0], exclude[1]] = False
    return set(np.flatnonzero(near.reshape(-1)).tolist())


def kept(s, r, m, n):
    s, r, m = (np.asarray(x) for x in (s, r, m))
    assert (s[~m] == 0).all() and (r[~m] == 0).all(), "empty slots must be (0, 0)"
    flat = s[m].astype(np.int64) * n + r[m]
    assert (np.diff(flat) > 0).all(), "kept pairs must be in increasing flat index"
    assert m[: m.sum()].all(), "kept pairs must lead the buffer"
    return flat.tolist()


def compare_world_edges(pos, mask, radius, capacity, exclude=None):
    """Port against JAX; returns (pairs kept, tie mismatches)."""
    n = pos.shape[0]
    ex = (None, None) if exclude is None else exclude
    js, jr, jm = jax_build_world_edges(
        jnp.asarray(pos), jnp.asarray(mask), radius, capacity,
        exclude_senders=None if ex[0] is None else jnp.asarray(ex[0]),
        exclude_receivers=None if ex[1] is None else jnp.asarray(ex[1]))
    ts, tr, tm = build_world_edges(
        torch.from_numpy(pos), torch.from_numpy(mask), radius, capacity,
        exclude_senders=None if ex[0] is None else torch.from_numpy(ex[0]),
        exclude_receivers=None if ex[1] is None else torch.from_numpy(ex[1]))
    assert ts.dtype == tr.dtype == torch.int32 and tm.dtype == torch.bool
    assert tuple(ts.shape) == tuple(tr.shape) == tuple(tm.shape) == (capacity,)
    a, b = kept(js, jr, jm, n), kept(ts.numpy(), tr.numpy(), tm.numpy(), n)
    ties = tie_pairs(pos, mask, radius, exclude)
    a_nt, b_nt = [x for x in a if x not in ties], [x for x in b if x not in ties]
    if len(a) < capacity and len(b) < capacity:
        assert a_nt == b_nt
    else:  # a full buffer: a tie moves the end by one pair
        k = min(len(a_nt), len(b_nt))
        assert a_nt[:k] == b_nt[:k]
        assert abs(len(a_nt) - len(b_nt)) <= len(ties)
    mismatches = len(set(a) ^ set(b))
    print(f"world edges: {len(b)} kept, {mismatches} pairs differ from JAX, "
          f"{len(ties)} pairs in the tie band")
    return len(b), mismatches


def flag_case(nx=12, ny=8, frame=3):
    pos, cells, nt = make_flag_mesh(nx, ny)
    wp = make_flag_trajectory(pos, nt, tl=frame + 1, dt=0.02, seed=0)[frame]
    t = build_template(pos, nt, cells=cells)
    n_pad = t.num_nodes
    wp_p = np.zeros((n_pad, 3), np.float32)
    wp_p[: len(pos)] = wp
    mask = np.arange(n_pad) < len(pos)
    excl = (t.senders.numpy(), t.receivers.numpy())
    return wp_p, mask, excl


@pytest.mark.parametrize("case", ["random", "flag", "mesh_exclusion", "truncation",
                                  "padding", "masked", "far_from_origin"])
def test_build_world_edges_matches_jax(case):
    rng = np.random.default_rng(len(case))
    n, radius, capacity, exclude = 64, 0.25, 2048, None
    pos = rng.random((n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    if case == "flag":
        pos, mask, exclude = flag_case()
        n, radius, capacity = pos.shape[0], 0.3, 256
    elif case == "mesh_exclusion":
        exclude = tuple(rng.integers(0, n, 300).astype(np.int32) for _ in range(2))
    elif case == "truncation":
        capacity = 100
    elif case == "padding":
        n, capacity = 6, 64
        pos, mask, radius = pos[:n], mask[:n], 0.9
    elif case == "masked":
        mask = rng.random(n) < 0.7
    elif case == "far_from_origin":
        pos = pos + np.float32(100.0)
    count, _ = compare_world_edges(pos, mask, radius, capacity, exclude)
    assert count > 0
    if case == "truncation":
        assert count == capacity
    if case == "padding":
        assert n * n < capacity and count < n * n


def test_build_world_edges_flag_exceeds_capacity():
    """The flag at rest has more radius hits than slots: the first
    ``capacity`` by flat index are kept, as in the JAX package."""
    pos, mask, excl = flag_case(frame=0)
    count, _ = compare_world_edges(pos, mask, 0.3, 128, excl)
    assert count == 128


def test_build_world_edges_key_guard():
    n = 46341  # n * n >= 2^31: raises before any (n, n) tensor is made
    with pytest.raises(ValueError, match="int32"):
        build_world_edges(torch.zeros((n, 3)), torch.ones(n, dtype=torch.bool), 0.1, 16)


# --- the unsorted segment sum --------------------------------------------------------

def test_segment_sum_unsorted_matches_jax():
    rng = np.random.default_rng(3)
    n, e, f = 50, 400, 16
    data = rng.normal(size=(e, f)).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    ref = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=n)
    out = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n,
                      indices_are_sorted=False)
    assert out.dtype == torch.float32 and tuple(out.shape) == (n, f)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --- K3's node_extra form ---------------------------------------------------------------

@pytest.mark.parametrize("latent", [16, 128])
def test_node_round_plain_extra_matches_jax(latent):
    rng = np.random.default_rng(latent)
    n = 40
    mlp = jax.tree.map(np.asarray, jax_init_mlp(jax.random.PRNGKey(latent), 2 * latent,
                                                latent, 2, latent, layer_norm=True))
    mlp["b"] = [rng.normal(size=b.shape).astype(np.float32) * 0.1 for b in mlp["b"]]
    v, agg, extra = (rng.normal(size=(n, latent)).astype(np.float32) for _ in range(3))
    ref = v + np.asarray(jax_apply_mlp_parts(mlp, (jnp.asarray(v), jnp.asarray(agg)),
                                             jnp.float32, extra=jnp.asarray(extra)))
    tv, tagg, tex = (torch.from_numpy(x) for x in (v, agg, extra))
    out = node_round_plain(tv, tagg, params_from_jax(mlp), tex)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the wrapper on a CPU tensor: the same plain version, in place
    v_in = tv.clone()
    node_round(v_in, tagg, params_from_jax(mlp), None, tex)
    assert torch.equal(v_in, out)
    # the extra is really added: without it the result differs
    assert not torch.allclose(node_round_plain(tv, tagg, params_from_jax(mlp)), out)


def test_fused_process_node_extra_refuses_a_gradient():
    cfg = MultiMGNConfig(node_input_dim=4, edge_input_dims=(3, 4), output_dim=3, latent_size=16,
                         hidden_layers=1, message_passing_steps=2)
    proc = init_mgn_multi(cfg, torch.Generator().manual_seed(0), device="cpu")["processor"]
    mesh = {"edge_mlp": proc["edge_mlps"][0], "node_mlp": dict(
        proc["node_mlp"], w=[proc["node_mlp"]["w"][0][:, :32]] + proc["node_mlp"]["w"][1:])}
    v0 = torch.zeros((8, 16), requires_grad=True)
    e0 = torch.zeros((4, 16))
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    rows = torch.tensor([0, 1, 2, 3, 4, 4, 4, 4, 4], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="cloth training"):
        fused_process(mesh, v0, e0, idx, idx, rows, torch.ones((4, 1)), 2,
                      node_extra=lambda r, v: torch.zeros_like(v))


# --- the multi-edge-set model ---------------------------------------------------------

def multi_case():
    """The JAX package's fused-branch test case: a spatially ordered channel
    mesh (so the TPU kernel gets a banding plan) and 128 random world-edge
    slots, 100 live."""
    pos, cells, nt = make_channel_mesh(96, seed=2)
    extent = pos.max(0) - pos.min(0)
    axes_ = np.argsort(-extent)
    order = np.lexsort(tuple(pos[:, a] for a in reversed(axes_)))
    inv = np.empty(len(pos), np.int64)
    inv[order] = np.arange(len(pos))
    pos, nt, cells = pos[order], nt[order], inv[cells].astype(np.int32)
    jt = jax_build_template(pos, nt, cells=cells, node_bucket=128, edge_bucket=512)
    tt = build_template(pos, nt, cells=cells, node_bucket=128, edge_bucket=512)
    rng = np.random.default_rng(0)
    n_real, n_pad, e_pad = len(pos), tt.num_nodes, tt.num_edges
    nf = (rng.normal(size=(n_pad, 10)) * tt.node_mask.numpy()[:, None]).astype(np.float32)
    mesh_feat = (rng.normal(size=(e_pad, 3)) * tt.edge_mask.numpy()[:, None]).astype(np.float32)
    wcap = 128
    ws = rng.integers(0, n_real, wcap).astype(np.int32)
    wr = rng.integers(0, n_real, wcap).astype(np.int32)
    wm = np.ones(wcap, bool)
    wm[100:] = False
    wf = (rng.normal(size=(wcap, 4)) * wm[:, None]).astype(np.float32)
    jgraph = JaxMultiGraph(
        node_features=jnp.asarray(nf),
        edge_sets=(JaxEdgeSet(features=jnp.asarray(mesh_feat), senders=jt.senders,
                              receivers=jt.receivers, mask=jt.edge_mask,
                              row_offsets=jt.row_offsets),
                   JaxEdgeSet(features=jnp.asarray(wf), senders=jnp.asarray(ws),
                              receivers=jnp.asarray(wr), mask=jnp.asarray(wm))),
        node_mask=jt.node_mask)
    tgraph = MultiGraph(
        node_features=torch.from_numpy(nf),
        edge_sets=(EdgeSet(features=torch.from_numpy(mesh_feat), senders=tt.senders,
                           receivers=tt.receivers, mask=tt.edge_mask,
                           row_offsets=tt.row_offsets),
                   EdgeSet(features=torch.from_numpy(wf), senders=torch.from_numpy(ws),
                           receivers=torch.from_numpy(wr), mask=torch.from_numpy(wm))),
        node_mask=tt.node_mask)
    plan = build_fused_plan(np.asarray(jt.senders), np.asarray(jt.receivers), jt.num_nodes,
                            chunk=128)
    assert plan is not None
    return jgraph, tgraph, plan, n_real


@pytest.mark.parametrize("jax_route", ["xla", "fused"])
def test_apply_mgn_multi_matches_jax(jax_route):
    jgraph, tgraph, plan, n_real = multi_case()
    base = dict(node_input_dim=10, edge_input_dims=(3, 4), output_dim=3, latent_size=16,
                hidden_layers=1, message_passing_steps=2)
    jp = jax_init_mgn_multi(jax.random.PRNGKey(1), JaxMultiMGNConfig(**base))
    if jax_route == "fused":
        ref = jax_apply_mgn_multi(jp, jgraph, JaxMultiMGNConfig(**base, fused=True),
                                  fused_plan=plan)
    else:
        ref = jax_apply_mgn_multi(jp, jgraph, JaxMultiMGNConfig(**base,
                                                                aggregation_backend="xla"))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    out = apply_mgn_multi(params, tgraph, MultiMGNConfig(**base))
    assert out.dtype == torch.float32 and tuple(out.shape) == (128, 3)
    np.testing.assert_allclose(out.numpy()[:n_real], np.asarray(ref)[:n_real], atol=5e-4)


def test_apply_mgn_multi_takes_one_mesh_and_one_world_set():
    """The JAX fused branch's graph shape only: a third set, or world edges
    that carry CSR offsets, raise."""
    _, tgraph, _, _ = multi_case()
    mesh, world = tgraph.edge_sets
    base = dict(node_input_dim=10, output_dim=3, latent_size=16, hidden_layers=1,
                message_passing_steps=2)
    cfg3 = MultiMGNConfig(edge_input_dims=(3, 4, 4), **base)
    params = init_mgn_multi(cfg3, torch.Generator().manual_seed(0), device="cpu")
    three = dataclasses.replace(tgraph, edge_sets=(mesh, world, world))
    with pytest.raises(ValueError, match="a mesh set and a world set"):
        apply_mgn_multi(params, three, cfg3)
    cfg = MultiMGNConfig(edge_input_dims=(3, 4), **base)
    params = init_mgn_multi(cfg, torch.Generator().manual_seed(0), device="cpu")
    with_offsets = dataclasses.replace(tgraph, edge_sets=(
        mesh, dataclasses.replace(world, row_offsets=mesh.row_offsets)))
    with pytest.raises(ValueError, match="no row_offsets"):
        apply_mgn_multi(params, with_offsets, cfg)


def test_apply_mgn_multi_bf16_runs_the_same_math():
    """bf16 is held against the port's own f32 path only: the JAX package
    sums the world messages in bf16, the port in f32 (ROADMAP C)."""
    _, tgraph, _, n_real = multi_case()
    cfg = MultiMGNConfig(node_input_dim=10, edge_input_dims=(3, 4), output_dim=3,
                         latent_size=16, hidden_layers=1, message_passing_steps=2)
    params = init_mgn_multi(cfg, torch.Generator().manual_seed(4), device="cpu")
    f32 = apply_mgn_multi(params, tgraph, cfg)[:n_real]
    bf16 = apply_mgn_multi(params, tgraph, dataclasses.replace(
        cfg, compute_dtype=torch.bfloat16))[:n_real]
    assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
    assert float((bf16 - f32).norm() / f32.norm()) < 5e-2


# --- the cloth rollout and the simulator ----------------------------------------------

T, RADIUS, CAPACITY = 10, 0.3, 256


def online_np(x, max_acc=1e7):
    """Online accumulator fields filled from data rows (f64 sums)."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    return dict(acc_count=np.float32(1.0), num_accumulations=np.float32(len(x)),
                acc_sum=x.sum(0).astype(np.float32), acc_sum_sq=(x * x).sum(0).astype(np.float32),
                max_acc=np.float32(max_acc), std_epsilon=np.float32(1e-8))


@pytest.fixture(scope="module")
def flag_setup():
    pos, cells, nt = make_flag_mesh(12, 8)
    assert all(np.array_equal(a, b) for a, b in zip((pos, cells, nt), jax_make_flag_mesh(12, 8)))
    wp = make_flag_trajectory(pos, nt, tl=T, dt=0.02, seed=5)
    assert np.array_equal(wp, jax_make_flag_trajectory(pos, nt, tl=T, dt=0.02, seed=5))
    meta = flag_meta(T, 1, 1)
    jt = jax_build_template(pos, nt, cells=cells)
    n, n_pad = len(pos), jt.num_nodes
    wp_pad = np.zeros((T, n_pad, 3), np.float32)
    wp_pad[:, :n] = wp
    times = (np.arange(T) * 0.02).astype(np.float32)
    # normalizers filled from the trajectory's own statistics
    s, r = np.asarray(jt.senders)[np.asarray(jt.edge_mask)], np.asarray(jt.receivers)[
        np.asarray(jt.edge_mask)]
    rel = wp[:, s] - wp[:, r]
    mef = np.asarray(jt.mesh_edge_features)[np.asarray(jt.edge_mask)]
    mesh_rows = np.concatenate([np.broadcast_to(mef, rel.shape[:2] + (3,)), rel,
                                np.linalg.norm(rel, axis=-1, keepdims=True)], -1)
    vel = np.diff(wp, axis=0) / 0.02
    acc = np.diff(wp, 2, axis=0) / 0.02 ** 2
    world = np.concatenate([rel[..., :3] * 3.0, np.linalg.norm(rel, axis=-1,
                                                               keepdims=True) * 3.0], -1)
    fields = {"mesh": online_np(mesh_rows), "world": online_np(world),
              "velocity": online_np(vel), "acceleration": online_np(acc)}
    j = {k: JN.Online(**{f: jnp.asarray(x) for f, x in v.items()}) for k, v in fields.items()}
    jnorm = JaxNormState(edge={"mesh": j["mesh"], "world": j["world"]},
                         node={"velocity": j["velocity"],
                               "node_type": JN.OfflineMinMax.create(0.0, 1.0)},
                         output={"acceleration": j["acceleration"]})
    mcfg = jax_cloth_model_config(meta, latent=16, hidden_layers=1, mps=2)
    jcfg = JaxClothConfig(model=mcfg, world_radius=RADIUS, world_capacity=CAPACITY)
    jp = jax_init_mgn_multi(jax.random.PRNGKey(0), mcfg)
    ref = np.asarray(jax.jit(jax_make_cloth_rollout(jcfg))(jp, jnorm, jt, jnp.asarray(wp_pad),
                                                          jnp.asarray(times)))
    tcfg = ClothConfig(model=cloth_model_config(meta, latent=16, hidden_layers=1, mps=2),
                       world_radius=RADIUS, world_capacity=CAPACITY)
    return dict(pos=pos, cells=cells, nt=nt, wp=wp, wp_pad=wp_pad, times=times, ref=ref,
                params=params_from_jax(jax.tree.map(np.asarray, jp)),
                norm=norm_from_jax(jax.tree.map(np.asarray, jnorm)), cfg=tcfg,
                template=build_template(pos, nt, cells=cells), jp=jp, jnorm=jnorm)


def test_cloth_model_config_matches_jax():
    meta = flag_meta(T, 1, 1)
    cfg = cloth_model_config(meta, latent=16, hidden_layers=1, mps=2)
    jcfg = jax_cloth_model_config(meta, latent=16, hidden_layers=1, mps=2)
    assert (cfg.node_input_dim, cfg.edge_input_dims, cfg.output_dim) == (
        jcfg.node_input_dim, tuple(jcfg.edge_input_dims), jcfg.output_dim) == (10, (7, 4), 3)
    state = make_cloth_norm_state(ClothConfig(model=cfg))
    jstate = jax_make_cloth_norm_state(JaxClothConfig(model=jcfg))
    assert set(state.edge) == set(jstate.edge) == {"mesh", "world"}
    for k in state.edge:
        assert state.edge[k].acc_sum.shape == jstate.edge[k].acc_sum.shape


def test_make_cloth_rollout_matches_jax(flag_setup):
    s = flag_setup
    with torch.no_grad():
        pred = make_cloth_rollout(s["cfg"])(s["params"], s["norm"], s["template"],
                                            torch.from_numpy(s["wp_pad"]),
                                            torch.from_numpy(s["times"]))
    n = len(s["pos"])
    assert tuple(pred.shape) == s["ref"].shape and torch.isfinite(pred).all()
    handles = s["nt"] == 3
    assert np.array_equal(pred.numpy()[:, :n][:, handles], s["wp"][:, handles])
    assert np.abs(pred.numpy()[-1, :n] - s["wp"][-1]).max() > 1e-3  # the cloth moved
    np.testing.assert_allclose(pred.numpy()[:, :n], s["ref"][:, :n], rtol=1e-4, atol=1e-5)


def test_cloth_simulator_cpu_matches_rollout(flag_setup):
    s = flag_setup
    sim = cloth_simulator(s["params"], s["norm"], s["pos"], s["nt"], s["cells"], s["cfg"],
                          num_steps=T, device="cpu")
    pred = sim(s["times"], s["wp"])
    assert pred.shape == s["wp"].shape and pred.dtype == np.float32
    with torch.no_grad():
        roll = make_cloth_rollout(s["cfg"])(s["params"], s["norm"], s["template"],
                                            torch.from_numpy(s["wp_pad"]),
                                            torch.from_numpy(s["times"]))
    assert np.array_equal(pred, roll.numpy()[:, : len(s["pos"])])
    np.testing.assert_allclose(pred, s["ref"][:, : len(s["pos"])], rtol=1e-4, atol=1e-5)
    assert np.array_equal(sim(s["times"], s["wp"]), pred)  # the built template is reused
    with pytest.raises(ValueError, match="expected times"):
        sim(s["times"][:-1], s["wp"][:-1])


def test_cloth_simulator_needs_a_gpu_by_default(flag_setup, monkeypatch):
    s = flag_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cloth_simulator(s["params"], s["norm"], s["pos"], s["nt"], s["cells"], s["cfg"])


def test_cloth_state_converts_and_checkpoints(flag_setup, tmp_path):
    """params_from_jax / norm_from_jax carry a cloth state (edge-set lists,
    dict edge normalizers) across, and a port checkpoint round-trips it."""
    s = flag_setup
    params, norm = s["params"], s["norm"]
    assert len(params["edge_encoders"]) == 2 and len(params["processor"]["edge_mlps"]) == 2
    jleaves = jax.tree.leaves(s["jp"])
    tleaves = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), params))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert np.array_equal(np.asarray(a), b)
    assert isinstance(norm.edge, dict) and set(norm.edge) == {"mesh", "world"}
    assert isinstance(norm.edge["world"], TN.Online)
    np.testing.assert_array_equal(norm.edge["world"].acc_sum.numpy(),
                                  np.asarray(s["jnorm"].edge["world"].acc_sum))
    again = NormState.from_state_dict(norm.state_dict())
    assert set(again.edge) == {"mesh", "world"}
    assert torch.equal(again.edge["mesh"].acc_sum_sq, norm.edge["mesh"].acc_sum_sq)
    CheckpointManager(str(tmp_path)).save(TrainState(params, None, norm, 3), loss=0.0)
    model = CheckpointManager(str(tmp_path)).restore_model(device="cpu")
    assert torch.equal(model["norm"].edge["world"].acc_sum, norm.edge["world"].acc_sum)
    assert torch.equal(model["params"]["processor"]["edge_mlps"][1]["w"][0],
                       params["processor"]["edge_mlps"][1]["w"][0])
    assert model["norm"].to("cpu").edge["mesh"].acc_sum.device.type == "cpu"
