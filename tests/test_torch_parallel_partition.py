"""The port's partitioning and exchange plans (mgn_tpu_torch.parallel.partition,
the numpy copy of mgn_tpu.parallel.partition) bit for bit against the JAX
package's, the kernels' table invariants, spatial_reorder, and the
graph-parallel refusals, on the CPU (no process group)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mgn_tpu.parallel import mesh as JM
from mgn_tpu.parallel import partition as JP
import mgn_tpu_torch
from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import cells_to_edges
from mgn_tpu_torch.data.synthetic import make_channel_mesh, write_synthetic_tfrecord_dataset
from mgn_tpu_torch.parallel import halo as H
from mgn_tpu_torch.parallel import mesh as M
from mgn_tpu_torch.parallel import partition as TP
from mgn_tpu_torch.train.strategies import SolverTraining

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATE_FIELDS = ("node_type_onehot", "mesh_edge_features", "senders_global",
                   "receivers_local", "row_offsets", "node_mask", "edge_mask", "node_type",
                   "perm")
DEEP_FIELDS = ("src", "own_pos", "serve", "serve_mask", "senders", "receivers", "edge_mask",
               "mef", "rows")


def _mesh(n, seed=0):
    pos, cells, nt = make_channel_mesh(n, seed=seed)
    s, r = cells_to_edges(cells)
    return pos, cells, nt, s, r


@pytest.mark.parametrize("n,parts", [(128, 2), (128, 4), (400, 8)])
def test_bisect_partition_matches_jax(n, parts):
    pos = _mesh(n)[0]
    np.testing.assert_array_equal(TP.bisect_partition(pos, parts),
                                  JP.bisect_partition(pos, parts))


@pytest.mark.parametrize("n,parts", [(120, 2), (400, 4), (5233, 2)])
def test_refine_partition_matches_jax_where_the_floor_does_not_bind(n, parts):
    """On the channel meshes the source-part floor never binds: the port's
    refinement is the JAX package's, bit for bit."""
    pos, _, _, s, r = _mesh(n)
    part = TP.bisect_partition(pos, parts)
    np.testing.assert_array_equal(TP.refine_partition(part, s, r, parts),
                                  JP.refine_partition(part, s, r, parts))


def test_refine_partition_keeps_the_source_part_above_its_floor():
    """A part whose every node prefers another part: the JAX refinement
    drains it below floor(n / P * (1 - slack)) (ADVICE defect 2, moves
    bounded only by the destination cap); the port stops at the floor and
    still lowers the cut."""
    parts, per = 4, 10
    part = np.repeat(np.arange(parts), per).astype(np.int32)
    s, r = [], []
    for v in range(per):  # part 0's nodes: three neighbours in one other part, none in 0
        q = 1 + v % 3
        for u in range(q * per, q * per + 3):
            s += [v, u]
            r += [u, v]
    for q in range(1, parts):  # the other parts: cliques, whose nodes stay
        for a in range(q * per, (q + 1) * per):
            for b in range(q * per, (q + 1) * per):
                if a != b:
                    s.append(a)
                    r.append(b)
    s, r = np.asarray(s), np.asarray(r)
    n = parts * per
    floor = int(np.floor(n / parts * (1 - 0.03)))

    def cut(p):
        return int((p[s] != p[r]).sum())

    jax_sizes = np.bincount(JP.refine_partition(part, s, r, parts), minlength=parts)
    got = TP.refine_partition(part, s, r, parts)
    sizes = np.bincount(got, minlength=parts)
    assert jax_sizes[0] < floor <= sizes.min()
    assert cut(got) < cut(part)


@pytest.mark.parametrize("n,parts,spatial", [(120, 2, False), (400, 4, False),
                                             (400, 4, True)])
def test_partition_template_matches_jax(n, parts, spatial):
    pos, _, nt, s, r = _mesh(n)
    a = JP.partition_template(pos, nt, s, r, parts, spatial_order=spatial)
    b = TP.partition_template(pos, nt, s, r, parts, spatial_order=spatial)
    assert (a.num_parts, a.part_nodes) == (b.num_parts, b.part_nodes)
    for f in TEMPLATE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("n,parts", [(120, 2), (400, 4)])
def test_add_halo_plan_matches_jax(n, parts):
    pos, _, nt, s, r = _mesh(n)
    a = JP.add_halo_plan(JP.partition_template(pos, nt, s, r, parts), split_boundary=False)
    b = TP.add_halo_plan(TP.partition_template(pos, nt, s, r, parts))
    assert a.halo_size == b.halo_size
    for f in ("halo_serve", "halo_serve_mask", "senders_halo", "row_offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_add_deep_halo_plan_matches_jax(rounds):
    pos, _, nt, s, r = _mesh(120)
    pt = TP.partition_template(pos, nt, s, r, 2)
    a = JP.add_deep_halo_plan(JP.partition_template(pos, nt, s, r, 2), pos, s, r, rounds, 4,
                              build_fused=False)
    b = TP.add_deep_halo_plan(pt, pos, s, r, rounds, 4)
    assert (a.halo_size, a.n_ext, a.depth, a.rounds) == (b.halo_size, b.n_ext, b.depth,
                                                         b.rounds)
    for f in DEEP_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert TP.deep_depth(rounds, 4) == JP.deep_depth(rounds, 4)
    with pytest.raises(ValueError, match="divide"):
        TP.add_deep_halo_plan(pt, pos, s, r, 3, 4)


@pytest.mark.parametrize("exchange", ["gather", "halo", "deep"])
def test_every_part_meets_the_kernels_invariants(exchange):
    """shard_graph checks each part's table (receiver-sorted CSR, dead edges
    in pad rows, the sender CSR) and, for the deep plan, that its gather
    maps every own and received row once."""
    pos, _, nt, s, r = _mesh(400)
    pt = TP.add_halo_plan(TP.partition_template(pos, nt, s, r, 4))
    pt = dataclasses.replace(pt, deep=TP.add_deep_halo_plan(pt, pos, s, r, 2, 4))
    for p in range(4):
        sh = H.shard_graph(pt, p, exchange, "cpu")
        t = sh.tables
        order = t.senders[t.sender_perm.long()]
        assert torch.all(order[1:] >= order[:-1])
        assert int(t.sender_offsets[-1]) == len(t.senders)
        assert int(t.edge_mask.sum()) == int(pt.edge_mask[p].sum()) or exchange == "deep"


def test_kernel_tables_refuse_broken_tables():
    s = np.array([0, 1, 2, 3], np.int32)
    r = np.array([1, 1, 2, 4], np.int32)
    rows = np.array([0, 0, 2, 3, 3, 4], np.int32)
    m = np.array([True, True, True, False])
    TP.kernel_tables(s, r, rows, m, 5, "cpu")
    with pytest.raises(ValueError, match="sorted"):
        TP.kernel_tables(s, r[::-1].copy(), rows, m, 5, "cpu")
    with pytest.raises(ValueError, match="CSR row"):
        TP.kernel_tables(s, r, np.array([0, 1, 2, 3, 3, 4], np.int32), m, 5, "cpu")
    with pytest.raises(ValueError, match="dead edge"):
        TP.kernel_tables(s, r, np.array([0, 0, 2, 4, 4, 4], np.int32), m, 5, "cpu")
    with pytest.raises(ValueError, match="outside"):
        TP.kernel_tables(np.array([0, 1, 5, 3], np.int32), r, rows, m, 5, "cpu")


def test_serve_plan_sums_each_served_row_in_one_csr_row():
    serve = np.array([[3, 1, 3, 0], [1, 2, 0, 0]])
    mask = np.array([[True, True, True, False], [True, True, False, False]])
    plan = H.serve_plan(serve, mask, 5, "cpu")
    back = torch.arange(8, dtype=torch.float32)[:, None].repeat(1, 4)
    from mgn_tpu_torch.ops.csr_segment import csr_segment_sum
    got = csr_segment_sum(back, plan.serve, plan.offsets, 5, perm=plan.perm)[:, 0]
    want = np.zeros(5, np.float32)
    np.add.at(want, serve[mask], np.arange(8)[mask.reshape(-1)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_partition_stack_and_unpermute_round_trip():
    from mgn_tpu_torch.parallel.rollout import unpermute_sharded
    from mgn_tpu_torch.parallel.spmd import partition_stack
    pos, _, nt, s, r = _mesh(400)
    pt = TP.partition_template(pos, nt, s, r, 4)
    x = np.random.default_rng(0).normal(size=(3, len(pos), 2)).astype(np.float32)
    stacked = partition_stack(pt, x)  # (P, T, N_p, 2)
    assert stacked.shape == (4, 3, pt.part_nodes, 2)
    np.testing.assert_array_equal(unpermute_sharded(pt, stacked.transpose(1, 0, 2, 3), len(pos)),
                                  x)


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12])
def test_mesh_shape_for_matches_jax(n):
    assert M.mesh_shape_for(n) == JM.mesh_shape_for(n)
    assert M.mesh_shape_for(n, prefer_graph=2 if n % 2 == 0 else 0) == \
        JM.mesh_shape_for(n, prefer_graph=2 if n % 2 == 0 else 0)


def test_one_process_needs_no_process_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.initialize_multihost("gloo") is False
    with pytest.raises(ValueError, match="backend"):
        M.initialize_multihost("mpi")
    with pytest.raises(ValueError, match="process group"):
        M.make_device_mesh(1, 2, "gloo")


def test_accumulate_synced_without_a_group_is_accumulate():
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    m = torch.tensor([True, True, False, True, True, False])
    a = N.accumulate_synced(N.Online.create(2), x, m)
    b = N.accumulate(N.Online.create(2), x, m)
    for f in ("acc_count", "num_accumulations", "acc_sum", "acc_sum_sq"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    offline = N.OfflineMinMax.create(0.0, 1.0)
    assert N.accumulate_synced(offline, x, m) is offline


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """A 60-node dataset and a 2-step checkpoint at width 8."""
    d = tmp_path_factory.mktemp("gp")
    ds, cp = str(d / "ds"), str(d / "cp")
    write_synthetic_tfrecord_dataset(ds, num_nodes=60, tl=5, n_train=1, n_valid=1, n_test=1)
    mgn_tpu_torch.train_network(0.0, lambda ps: torch.optim.Adam(ps, lr=1e-3), ds, cp,
                                device="cpu", steps=2, norm_steps=1, checkpoint=2,
                                solver_valid="euler", **MODEL)
    return ds, cp, str(d)


MODEL = dict(mps=2, layer_size=8, hidden_layers=1, seed=0)


def test_spatial_reorder_gives_the_plain_order_results(small_run):
    """simulate and eval_network with spatial_reorder=True (nodes in sweep
    order, results mapped back) equal the plain order's within rtol 1e-5."""
    from mgn_tpu_torch.data.pipeline import load_dataset
    ds, cp, d = small_run
    tr = load_dataset(ds, is_training=False).trajectory(0)
    call = dict(cells=tr.cells, device="cpu", **MODEL)
    args = (ds, cp, tr.mesh_pos, tr.node_type, {"velocity": tr.fields["velocity"][0]},
            tr.times)
    plain = mgn_tpu_torch.simulate(*args, **call)
    swept = mgn_tpu_torch.simulate(*args, spatial_reorder=True, **call)
    np.testing.assert_allclose(swept, plain, rtol=1e-5, atol=1e-6)
    kw = dict(solver="euler", num_rollouts=1, mse_steps=(1, 3), device="cpu", **MODEL)
    a = mgn_tpu_torch.eval_network(ds, cp, d + "/plain", **kw)
    b = mgn_tpu_torch.eval_network(ds, cp, d + "/swept", spatial_reorder=True, **kw)
    np.testing.assert_allclose(b[0]["error"], a[0]["error"], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("entry", ["train_network", "eval_network", "simulate"])
def test_graph_parallel_without_a_process_group_names_torchrun(small_run, entry):
    from mgn_tpu_torch.data.pipeline import load_dataset
    ds, cp, d = small_run
    tr = load_dataset(ds, is_training=False).trajectory(0)
    calls = {
        "train_network": lambda: mgn_tpu_torch.train_network(
            0.0, lambda ps: torch.optim.Adam(ps), ds, d + "/cp_gp", device="cpu", steps=2,
            graph_parallel=2, **MODEL),
        "eval_network": lambda: mgn_tpu_torch.eval_network(
            ds, cp, d + "/out_gp", device="cpu", graph_parallel=2, **MODEL),
        "simulate": lambda: mgn_tpu_torch.simulate(
            ds, cp, tr.mesh_pos, tr.node_type, {"velocity": tr.fields["velocity"][0]},
            tr.times, cells=tr.cells, device="cpu", graph_parallel=2, **MODEL),
    }
    with pytest.raises(ValueError, match="torchrun"):
        calls[entry]()


def test_graph_parallel_refusals_name_a7b(small_run):
    """The sharded artefact is export_sharded_simulator's, which
    export_simulator names; graph-parallel solver training runs
    (tests/test_torch_parallel_solver.py), and outside a process group asks
    for one, naming torchrun."""
    from mgn_tpu_torch.data.pipeline import load_dataset
    from mgn_tpu_torch.serve import export_simulator
    ds, cp, d = small_run
    with pytest.raises(ValueError, match="torchrun"):
        mgn_tpu_torch.train_network(
            0.0, lambda ps: torch.optim.Adam(ps), ds, d + "/cp_solver", device="cpu", steps=2,
            graph_parallel=2, training_strategy=SolverTraining(0.0, 0.01, 0.03), **MODEL)
    tr = load_dataset(ds, is_training=False).trajectory(0)
    with pytest.raises(ValueError, match="export_sharded_simulator"):
        export_simulator(ds, cp, tr.mesh_pos, tr.node_type, num_steps=3, cells=tr.cells,
                         device="cpu", graph_parallel=2, **MODEL)
    with pytest.raises(ValueError, match="must divide"):
        mgn_tpu_torch.simulate(ds, cp, tr.mesh_pos, tr.node_type,
                               {"velocity": tr.fields["velocity"][0]}, tr.times,
                               cells=tr.cells, device="cpu", graph_parallel=2, halo_rounds=3,
                               **{**MODEL, "mps": 4})


def test_parallel_modules_import_without_jax():
    """Each new module imports in a fresh process whose jax, mgn_tpu and h5py
    imports fail."""
    mods = ["mgn_tpu_torch.parallel.mesh", "mgn_tpu_torch.parallel.partition",
            "mgn_tpu_torch.parallel.halo", "mgn_tpu_torch.parallel.spmd",
            "mgn_tpu_torch.parallel.rollout", "mgn_tpu_torch.api_spmd",
            "mgn_tpu_torch.parallel.cloth", "mgn_tpu_torch.train.loop"]
    code = ("import sys\n"
            "for m in ('jax', 'mgn_tpu', 'h5py'):\n    sys.modules[m] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "assert not any(k == 'jax' or k.startswith(('jax.', 'mgn_tpu.')) "
              "for k, v in sys.modules.items() if v is not None)\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
