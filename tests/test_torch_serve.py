"""Port: the serving artefacts (``mgn_tpu_torch.serve``: ``export_simulator``,
``export_cloth_simulator``, ``load_simulator``) and the serving kernels'
operators (``mgn_tpu_torch.ops.library``) on the CPU, against the eager
routes bit for bit and against the JAX package's artefacts."""

import dis
import inspect
import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import init_state
from mgn_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.core import normalizers as JN
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.data.synthetic import make_channel_mesh, make_trajectory, synthetic_meta
from mgn_tpu.models.mgn_multi import init_mgn_multi as jax_init_mgn_multi
from mgn_tpu.serve import export_cloth_simulator as jax_export_cloth_simulator
from mgn_tpu.serve import export_simulator as jax_export_simulator
from mgn_tpu.serve import load_simulator as jax_load_simulator
from mgn_tpu.train.cloth import ClothConfig as JaxClothConfig
from mgn_tpu.train.cloth import cloth_model_config as jax_cloth_model_config
from mgn_tpu.train.common import NormState as JaxNormState
import mgn_tpu_torch
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax, save_checkpoint_from_jax
from mgn_tpu_torch.data.synthetic import flag_meta, make_flag_mesh, make_flag_trajectory
from mgn_tpu_torch.ops import csr_segment as C
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops import library as L
from mgn_tpu_torch.serve import (cloth_simulator, export_cloth_simulator, export_simulator,
                                 load_simulator)
from mgn_tpu_torch.train.cloth import ClothConfig, cloth_model_config

torch.set_num_threads(2)

SMALL = dict(mps=3, layer_size=32, hidden_layers=2)
STEPS = 5  # Euler steps of the serving artefacts
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("weight_streams", "edge_project", "edge_round", "csr_segment_sum", "node_round")
# aten ops that only a kernel's plain version runs (K1's data-dependent CSR
# walk, the stream layouts' TF32 split): none may reach a traced graph
PLAIN_ONLY = ("repeat_interleave", "bincount", "index_add", "argsort", "bitwise_and")


def _online(norm, x):
    """An Online normalizer's accumulators filled from data rows."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    return norm.replace(acc_count=np.float32(1.0), num_accumulations=np.float32(len(x)),
                        acc_sum=x.sum(0).astype(np.float32),
                        acc_sum_sq=(x * x).sum(0).astype(np.float32))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A JAX checkpoint at width 32, 3 rounds, converted for the port; one
    initial frame of the 100-node channel mesh and 5 Euler steps."""
    root = tmp_path_factory.mktemp("artefact")
    dt = 0.01
    meta = synthetic_meta(tl=10, n_train=1, n_valid=1, dt=dt)
    with open(root / "meta.json", "w") as f:
        json.dump(meta, f)
    pos, cells, node_type = make_channel_mesh(100, seed=0)
    vel = make_trajectory(pos, node_type, tl=10, dt=dt, seed=5)
    state, _, _ = init_state(meta, JaxArgs(seed=3, **SMALL), optax.sgd(1.0))
    t = jax_build_template(pos, node_type, cells=cells)
    mef = np.asarray(t.mesh_edge_features)[np.asarray(t.edge_mask)]
    norm = state.norm.replace(
        edge=_online(state.norm.edge, mef),
        node={**state.norm.node, "velocity": _online(state.norm.node["velocity"], vel)},
        output={"velocity": _online(state.norm.output["velocity"], np.diff(vel, axis=0) / dt)})
    state = state.replace(norm=jax.tree.map(lambda a: np.asarray(a), norm))
    jax_cp = str(root / "cp_jax")
    JaxCheckpointManager(jax_cp).save(state, loss=0.0)
    model = JaxCheckpointManager(jax_cp).restore_model(
        JaxCheckpointManager.model_subtree(state))
    torch_cp = str(root / "cp_torch")
    save_checkpoint_from_jax(jax.tree.map(np.asarray, model), torch_cp)
    times = (np.arange(STEPS + 1) * dt).astype(np.float32)
    mesh = dict(mesh_pos=pos, node_type=node_type, cells=cells)
    blob = export_simulator(str(root), torch_cp, num_steps=len(times), device="cpu", **mesh,
                            **SMALL)
    return dict(root=str(root), jax_cp=jax_cp, torch_cp=torch_cp, mesh=mesh, v0=vel[0],
                times=times, blob=blob)


def _simulate(c, **kwargs):
    return mgn_tpu_torch.simulate(c["root"], c["torch_cp"], initial_fields={"velocity": c["v0"]},
                                  times=c["times"], device="cpu", **c["mesh"], **SMALL, **kwargs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artefact_gives_simulate_bits(case, dtype):
    """The artefact runs the same operators in the same order on the same
    inputs as simulate: the same bits, f32 and bf16."""
    c = case
    blob = c["blob"] if dtype == "float32" else export_simulator(
        c["root"], c["torch_cp"], num_steps=len(c["times"]), device="cpu",
        compute_dtype=dtype, **c["mesh"], **SMALL)
    out = load_simulator(blob, device="cpu")(c["times"], c["v0"])
    ref = _simulate(c, compute_dtype=dtype)
    assert out.dtype == np.float32 and out.shape == ref.shape == (STEPS + 1, 100, 2)
    assert np.abs(out[-1] - out[0]).max() > 1e-3  # the state evolved
    assert np.array_equal(out, ref)
    # tensors in, numpy out
    assert np.array_equal(load_simulator(blob, device="cpu")(torch.from_numpy(c["times"]),
                                                              torch.from_numpy(c["v0"])), out)


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_artefact_matches_jax_artefact(case, solver):
    c = case
    blob = c["blob"] if solver == "euler" else export_simulator(
        c["root"], c["torch_cp"], num_steps=len(c["times"]), solver=solver, device="cpu",
        **c["mesh"], **SMALL)
    jblob = jax_export_simulator(c["root"], c["jax_cp"], num_steps=len(c["times"]),
                                 solver=solver, **c["mesh"], **SMALL)
    ref = np.asarray(jax_load_simulator(jblob)(jnp.asarray(c["times"]), jnp.asarray(c["v0"])))
    out = load_simulator(blob, device="cpu")(c["times"], c["v0"])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_spatially_reordered_artefact_gives_simulate_bits(case):
    """With ``spatial_reorder`` the template's rows are the mesh's nodes in
    sweep order: the artefact permutes through that order (the parent baked
    the identity, 0.16 off), giving simulate's bits and the JAX artefact's
    result within 1e-4."""
    c = case
    blob = export_simulator(c["root"], c["torch_cp"], num_steps=len(c["times"]), device="cpu",
                            spatial_reorder=True, **c["mesh"], **SMALL)
    out = load_simulator(blob, device="cpu")(c["times"], c["v0"])
    assert np.array_equal(out, _simulate(c, spatial_reorder=True))
    jblob = jax_export_simulator(c["root"], c["jax_cp"], num_steps=len(c["times"]),
                                 spatial_reorder=True, **c["mesh"], **SMALL)
    ref = np.asarray(jax_load_simulator(jblob)(jnp.asarray(c["times"]), jnp.asarray(c["v0"])))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_artefact_state_rebuilds_named_tuples():
    """An artefact's state may hold named tuples (a rank's ``KernelTables``,
    ``ServePlan``, ``DeepStage``): split into buffers and joined back, each
    is rebuilt field by field with its tensors and its ints."""
    from mgn_tpu_torch.parallel.halo import DeepStage, ServePlan
    from mgn_tpu_torch.parallel.partition import kernel_tables
    from mgn_tpu_torch.serve import _join, _split

    tables = kernel_tables(np.array([0, 1, 2]), np.array([0, 1, 2]), np.array([0, 1, 2, 3, 3]),
                           np.array([True, True, True]), 4, "cpu")
    plan = ServePlan(torch.arange(4), torch.arange(4), torch.arange(3), 2)
    stage = DeepStage(3, torch.arange(2), torch.arange(1), torch.arange(2), tables)
    state = dict(tables=tables, serve=plan, stages=[stage], rows=torch.ones(2))
    leaves, names = [], []
    spec = _split(state, leaves, names, "")
    back = _join(spec, leaves)
    assert type(back["tables"]) is type(tables) and back["tables"].rows == 4
    assert type(back["serve"]) is ServePlan and back["serve"].rows == 2
    assert type(back["stages"]) is list and type(back["stages"][0]) is DeepStage
    assert back["stages"][0].rounds == 3 and back["stages"][0].tables.rows == 4
    assert all(torch.equal(a, b) for a, b in zip(tables[:6], back["stages"][0].tables[:6]))
    assert len(leaves) == len(names) == 6 + 3 + 3 + 6 + 1
    assert torch.equal(back["serve"].offsets, plan.offsets)


@pytest.mark.parametrize("platforms", [["cpu", "tpu"], ["cuda"], ["gpu"]])
def test_platforms_other_than_the_export_device_raise(case, platforms):
    c = case
    with pytest.raises(ValueError, match="platform"):
        export_simulator(c["root"], c["torch_cp"], num_steps=3, platforms=platforms,
                         device="cpu", **c["mesh"], **SMALL)


def test_load_without_device_needs_a_gpu(case):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_simulator(case["blob"])


def test_graph_holds_the_operators(case):
    """The exported program calls each serving operator once per forward
    (weight_streams) or once per round, mutates e and v in place with no
    functionalising wrapper, and holds no op of a plain version."""
    program = torch.export.load(__import__("io").BytesIO(case["blob"]))
    calls = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    forwards, rounds = STEPS, STEPS * SMALL["mps"]
    assert {op: calls[f"mgn_tpu_torch.{op}.default"] for op in OPS} == dict(
        weight_streams=forwards, edge_project=rounds, edge_round=rounds,
        csr_segment_sum=rounds, node_round=rounds)
    assert not [k for k in calls if "auto_functionalized" in k]
    assert not [k for k in calls if any(p in k for p in PLAIN_ONLY)], sorted(calls)
    assert not _data_dependent(case["blob"])


def _data_dependent(blob):
    """The graph's reads of a tensor's value on the host (``item``): each is a
    device sync a call, and a trace that stricter torch releases refuse."""
    program = torch.export.load(__import__("io").BytesIO(blob))
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"
            and any(k in str(n.target) for k in ("aten.item", "_local_scalar_dense"))]


def test_fresh_process_runs_the_artefact(case, tmp_path):
    """A process that imports only load_simulator runs the bytes to the same
    bits, with nothing of JAX, mgn_tpu or the port's api, models or data."""
    c = case
    (tmp_path / "sim.pt2").write_bytes(c["blob"])
    np.save(tmp_path / "times.npy", c["times"])
    np.save(tmp_path / "v0.npy", c["v0"])
    code = ("import sys, numpy as np\n"
            "from mgn_tpu_torch.serve import load_simulator\n"
            f"d = {str(tmp_path)!r}\n"
            "sim = load_simulator(open(d + '/sim.pt2', 'rb').read(), device='cpu')\n"
            "np.save(d + '/out.npy', sim(np.load(d + '/times.npy'), np.load(d + '/v0.npy')))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'mgn_tpu') or m.startswith(('mgn_tpu_torch.api', 'mgn_tpu_torch.models', "
            "'mgn_tpu_torch.data'))))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout
    assert np.array_equal(np.load(tmp_path / "out.npy"), _simulate(c))


# --- the cloth family ----------------------------------------------------------------

T, RADIUS, CAPACITY = 8, 0.3, 256


def _online_np(x):
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    return dict(acc_count=np.float32(1.0), num_accumulations=np.float32(len(x)),
                acc_sum=x.sum(0).astype(np.float32), acc_sum_sq=(x * x).sum(0).astype(np.float32),
                max_acc=np.float32(1e7), std_epsilon=np.float32(1e-8))


@pytest.fixture(scope="module")
def flag():
    """The 12 x 8 flag at width 16, 2 rounds, with JAX weights and
    normalizers filled from the trajectory, converted for the port."""
    pos, cells, nt = make_flag_mesh(12, 8)
    wp = make_flag_trajectory(pos, nt, tl=T, dt=0.02, seed=5)
    times = (np.arange(T) * 0.02).astype(np.float32)
    jt = jax_build_template(pos, nt, cells=cells)
    live = np.asarray(jt.edge_mask)
    s, r = np.asarray(jt.senders)[live], np.asarray(jt.receivers)[live]
    rel = wp[:, s] - wp[:, r]
    mef = np.asarray(jt.mesh_edge_features)[live]
    mesh_rows = np.concatenate([np.broadcast_to(mef, rel.shape[:2] + (3,)), rel,
                                np.linalg.norm(rel, axis=-1, keepdims=True)], -1)
    world = np.concatenate([rel * 3.0, np.linalg.norm(rel, axis=-1, keepdims=True) * 3.0], -1)
    j = {k: JN.Online(**{f: jnp.asarray(x) for f, x in _online_np(v).items()})
         for k, v in dict(mesh=mesh_rows, world=world, velocity=np.diff(wp, axis=0) / 0.02,
                          acceleration=np.diff(wp, 2, axis=0) / 0.02 ** 2).items()}
    jnorm = JaxNormState(edge={"mesh": j["mesh"], "world": j["world"]},
                         node={"velocity": j["velocity"],
                               "node_type": JN.OfflineMinMax.create(0.0, 1.0)},
                         output={"acceleration": j["acceleration"]})
    meta = flag_meta(T, 1, 1)
    jcfg = JaxClothConfig(model=jax_cloth_model_config(meta, latent=16, hidden_layers=1, mps=2),
                          world_radius=RADIUS, world_capacity=CAPACITY)
    jp = jax_init_mgn_multi(jax.random.PRNGKey(0), jcfg.model)
    cfg = ClothConfig(model=cloth_model_config(meta, latent=16, hidden_layers=1, mps=2),
                      world_radius=RADIUS, world_capacity=CAPACITY)
    mesh = dict(mesh_pos=pos, node_type=nt, cells=cells)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    norm = norm_from_jax(jax.tree.map(np.asarray, jnorm))
    blob = export_cloth_simulator(params, norm, cfg=cfg, num_steps=T, device="cpu", **mesh)
    return dict(wp=wp, times=times, mesh=mesh, params=params, norm=norm, cfg=cfg, jp=jp,
                jnorm=jnorm, jcfg=jcfg, blob=blob)


def test_cloth_artefact_gives_cloth_simulator_bits(flag):
    f = flag
    out = load_simulator(f["blob"], device="cpu")(f["times"], f["wp"])
    ref = cloth_simulator(f["params"], f["norm"], cfg=f["cfg"], num_steps=T, device="cpu",
                          **f["mesh"])(f["times"], f["wp"])
    assert out.shape == f["wp"].shape and np.abs(out[-1] - f["wp"][-1]).max() > 1e-3
    assert np.array_equal(out, ref)
    assert not _data_dependent(f["blob"])


def test_cloth_artefact_matches_jax_artefact(flag):
    f = flag
    jblob = jax_export_cloth_simulator(f["jp"], f["jnorm"], cfg=f["jcfg"], num_steps=T,
                                       **f["mesh"])
    ref = np.asarray(jax_load_simulator(jblob)(jnp.asarray(f["times"]), jnp.asarray(f["wp"])))
    out = load_simulator(f["blob"], device="cpu")(f["times"], f["wp"])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


# --- the operators -------------------------------------------------------------------

def _operator_inputs(name, dtype=torch.float32):
    """Small inputs of one operator: 2 rounds of width 32, 12 nodes, 40
    edges sorted by receiver."""
    gen = torch.Generator().manual_seed(0)
    n, e, width, rounds = 12, 40, 32, 2
    randn = lambda *s: torch.randn(s, generator=gen)
    mlp = lambda parts: F.cast_mlp({
        "w": [randn(rounds, parts * width, width) * 0.2, randn(rounds, width, width) * 0.2],
        "b": [randn(rounds, width) * 0.1, randn(rounds, width) * 0.1],
        "ln_scale": 1 + 0.1 * randn(rounds, width), "ln_bias": 0.1 * randn(rounds, width)},
        dtype)
    em, nm = mlp(3), mlp(2)
    leaves_e, leaves_n = F._mlp_tensors(em), F._mlp_tensors(nm)
    receivers = torch.sort(torch.randint(0, n, (e,), generator=gen)).values.to(torch.int32)
    senders = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32)
    offsets = torch.searchsorted(receivers, torch.arange(n + 1, dtype=torch.int32)).to(
        torch.int32)
    perm = torch.randperm(e, generator=gen).to(torch.int32)
    v, ed = randn(n, width).to(dtype), randn(e, width).to(dtype)
    ws_e, ws_n, ws_p = F.weight_streams(em, nm)
    return {
        "weight_streams": (leaves_e, leaves_n, True, False),
        "edge_project": (v, em["w"][0], ws_p, 1),
        "edge_round": (ed, randn(n, width), randn(n, width), senders, receivers,
                       torch.ones(e, 1, dtype=dtype), leaves_e, ws_e, 1, width),
        "node_round": (v, randn(n, width), leaves_n, ws_n, 0, randn(n, width), width),
        "csr_segment_sum": (ed, offsets, n, perm),
        "csr_segment_sum_out": (ed, offsets, n, None, torch.empty(n, width)),
    }[name]


@pytest.mark.parametrize("name", L.OPERATORS)
def test_opcheck_cpu(name):
    """Schema (mutation and aliasing), fake shapes and dispatch of each
    operator's CPU implementation."""
    torch.library.opcheck(getattr(torch.ops.mgn_tpu_torch, name).default,
                          _operator_inputs(name))


def _calls(fn, seen=None):
    """The names of the functions ``fn`` calls, and, transitively, those
    that the port's functions among them call (read from the bytecode: a
    global or attribute loaded to be called; nothing runs)."""
    seen = set() if seen is None else seen
    codes = [fn.__code__]
    codes += [c for c in fn.__code__.co_consts if inspect.iscode(c)]  # lambdas, nested
    called = set()
    for code in codes:
        prev = None
        for ins in dis.get_instructions(code):
            # f(...): "NULL + f"; obj.f(...): "NULL|self + f"; module.f(...): "NULL + module", f
            if ins.opname in ("LOAD_GLOBAL", "LOAD_ATTR") and (
                    ins.argrepr.startswith("NULL") or (
                        ins.opname == "LOAD_ATTR" and prev is not None
                        and prev.opname == "LOAD_GLOBAL" and prev.argrepr.startswith("NULL"))):
                called.add(ins.argval)
            prev = ins
    modules = [m for m in fn.__globals__.values()
               if inspect.ismodule(m) and m.__name__.startswith("mgn_tpu_torch")]
    for name in called - seen:
        seen.add(name)
        for target in [fn.__globals__.get(name)] + [getattr(m, name, None) for m in modules]:
            if inspect.isfunction(target) and target.__module__.startswith("mgn_tpu_torch"):
                _calls(target, seen)
    return seen


@pytest.mark.parametrize("name", L.OPERATORS)
def test_cuda_implementation_is_the_kernel(name):
    """Each operator has a CUDA and a CPU kernel and a fake one registered;
    the CUDA one is the kernel's launch, whose code reaches no plain
    version (read from the registration, not run)."""
    qual = f"{L.NAMESPACE}::{name}"
    for key in ("CUDA", "CPU", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), (qual, key)
    impl = L.IMPLEMENTATIONS[name]
    assert impl["CUDA"] is L.CUDA_IMPLEMENTATIONS[name]
    reached = _calls(impl["CUDA"])
    assert {"library", "check"} <= reached  # loads the built library, checks the launch
    assert not [n for n in reached if n.endswith("_plain")], sorted(reached)
    assert [n for n in _calls(impl["CPU"]) if n.endswith("_plain")]


def test_launch_counters_live_in_the_cuda_implementations():
    """The wrappers' counters are raised by the CUDA implementations alone:
    a CPU call, or a trace, counts nothing."""
    before = {k: getattr(f, "launches") for k, f in (
        ("ws", F.weight_streams), ("k7", F.edge_project), ("k2", F.edge_round),
        ("k3", F.node_round), ("k1", C.csr_segment_sum))}
    for name in L.OPERATORS:
        out = getattr(torch.ops.mgn_tpu_torch, name)(*_operator_inputs(name))
        assert out is None or isinstance(out, (torch.Tensor, tuple))
    after = {k: getattr(f, "launches") for k, f in (
        ("ws", F.weight_streams), ("k7", F.edge_project), ("k2", F.edge_round),
        ("k3", F.node_round), ("k1", C.csr_segment_sum))}
    assert before == after
    for name, fn in L.CUDA_IMPLEMENTATIONS.items():
        src = inspect.getsource(fn)
        assert "launches" in src or "_launch(" in src, name
