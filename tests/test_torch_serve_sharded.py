"""Port: the sharded serving artefact (``mgn_tpu_torch.serve.
export_sharded_simulator`` / ``load_sharded_simulator``) on the CPU: two gloo
ranks spawned once for the module (tests/torch_serve_support.serve_rank)
export, load and run it on the deep, classic and telescoped plans with Euler
and the adaptive Tsit5, against ``simulate(graph_parallel=2)`` bit for bit,
the ranks against each other, and the JAX package's sharded artefact on the
8-device CPU mesh of tests/conftest.py (rtol 5e-4, atol 5e-5, as
tests/test_e2e.py holds the JAX one); ``python -m mgn_tpu_torch export
--graph-parallel 2`` and the refusals."""

import io
import zipfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import init_state
from mgn_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.serve import export_sharded_simulator as jax_export_sharded_simulator
from mgn_tpu.serve import load_sharded_simulator as jax_load_sharded_simulator
from mgn_tpu_torch.convert import save_checkpoint_from_jax
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.synthetic import write_synthetic_tfrecord_dataset
from mgn_tpu_torch.parallel.mesh import spawn
from mgn_tpu_torch.serve import export_sharded_simulator, load_sharded_simulator

from tests import torch_serve_support as S
from tests.test_torch_serve import _online

DT = 0.05  # save interval: the adaptive controller rejects tries
SAVES = 3


def _jax_reference(c, plan, solver):
    blob = jax_export_sharded_simulator(
        c["root"], c["jax_cp"], c["pos"], c["nt"], num_steps=len(c["times"]), cells=c["cells"],
        solver=solver, graph_parallel=2, **S.SMALL, **S.cell_args(plan, solver))
    return np.asarray(jax_load_sharded_simulator(blob)(jnp.asarray(c["times"]),
                                                       jnp.asarray(c["v0"])))


def make_case(root: str):
    """A synthetic dataset of the 120-node channel mesh, a JAX checkpoint
    at width 16, 4 rounds (normalizers filled from the trajectory),
    converted for the port; the test trajectory's first frame."""
    write_synthetic_tfrecord_dataset(root, num_nodes=120, tl=10, n_train=1, n_valid=1,
                                     n_test=1)
    ds = load_dataset(root, is_training=False)
    tr = ds.trajectory(0)
    meta = ds.meta
    vel = tr.fields["velocity"]
    state, _, _ = init_state(meta, JaxArgs(seed=3, **S.SMALL), optax.sgd(1.0))
    t = jax_build_template(tr.mesh_pos, tr.node_type, cells=tr.cells)
    mef = np.asarray(t.mesh_edge_features)[np.asarray(t.edge_mask)]
    dt = float(np.diff(tr.times)[0])
    norm = state.norm.replace(
        edge=_online(state.norm.edge, mef),
        node={**state.norm.node, "velocity": _online(state.norm.node["velocity"], vel)},
        output={"velocity": _online(state.norm.output["velocity"], np.diff(vel, axis=0) / dt)})
    state = state.replace(norm=jax.tree.map(lambda a: np.asarray(a), norm))
    jax_cp = root + "/cp_jax"
    JaxCheckpointManager(jax_cp).save(state, loss=0.0)
    model = JaxCheckpointManager(jax_cp).restore_model(JaxCheckpointManager.model_subtree(state))
    save_checkpoint_from_jax(jax.tree.map(np.asarray, model), root + "/cp")
    return dict(root=root, cp=root + "/cp", jax_cp=jax_cp, pos=tr.mesh_pos, nt=tr.node_type,
                cells=tr.cells, v0=vel[0], times=(np.arange(SAVES + 1) * DT).astype(np.float32))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """:func:`make_case`, the ranks' results and the JAX artefacts'."""
    c = make_case(str(tmp_path_factory.mktemp("sharded")))
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(spawn, 2, S.serve_rank, (c,))
        c["jax"] = {(plan, solver): _jax_reference(c, plan, solver)
                    for plan in S.PLANS for solver in S.SOLVERS}
        c["ranks"] = ranks.result()
    return c


CELLS = [(plan, solver) for plan in S.PLANS for solver in S.SOLVERS]


@pytest.mark.parametrize("plan,solver", CELLS)
def test_sharded_artefact_gives_simulate_bits(case, plan, solver):
    """Each rank's artefact gives ``simulate(graph_parallel=2)``'s bits, the
    same on both ranks and on a second call, from one module build."""
    r0, r1 = (r[plan, solver] for r in case["ranks"])
    assert r0["pred"].shape == (SAVES + 1, len(case["pos"]), 2)
    assert np.abs(r0["pred"][-1] - r0["pred"][0]).max() > 1e-3
    for r in (r0, r1):
        assert np.array_equal(r["pred"], r["ref"])
        assert np.array_equal(r["again"], r["pred"])
        assert r["builds"] == 1
    assert np.array_equal(r0["pred"], r1["pred"])
    if solver == "tsit5_adaptive":
        assert r0["stats"] == r1["stats"] and len(r0["stats"]) == SAVES
        assert sum(r for _, r in r0["stats"]) > 0  # the controller rejected tries
    else:
        assert r0["stats"] == []


@pytest.mark.parametrize("plan,solver", CELLS)
def test_sharded_artefact_matches_jax_sharded_artefact(case, plan, solver):
    np.testing.assert_allclose(case["ranks"][0][plan, solver]["pred"], case["jax"][plan, solver],
                               rtol=5e-4, atol=5e-5)


def test_export_graph_parallel_command_line(case):
    """``export --graph-parallel 2`` on two ranks: rank 0 writes the file,
    which the loader runs to the library artefact's bits."""
    for r in case["ranks"]:
        assert np.array_equal(r["cli"], r["deep", "euler"]["pred"])


def test_loader_refuses_a_group_of_the_wrong_size(case):
    for r in case["ranks"]:
        assert "artefact needs 2 ranks, got 1" in r["refusal"]


def test_outside_a_process_group_both_name_torchrun(case):
    c = case
    with pytest.raises(ValueError, match="torchrun"):
        export_sharded_simulator(c["root"], c["cp"], c["pos"], c["nt"], num_steps=3,
                                 cells=c["cells"], graph_parallel=2, device="cpu", **S.SMALL)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("mgn_tpu_torch.json", '{"graph_parallel": 2}')
    with pytest.raises(ValueError, match="torchrun"):
        load_sharded_simulator(buf.getvalue(), device="cpu")
    assert not torch.distributed.is_initialized()
