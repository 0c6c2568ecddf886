"""train_network, eval_network, simulate and the command line with
graph_parallel=2 (the deep and the classic exchange) against the port's
single-device runs on the CPU: two gloo ranks spawned once for the module
(tests/torch_parallel_support.api_rank), each calling the entry points with
the same arguments."""

import numpy as np
import pytest
import torch

import mgn_tpu_torch
from mgn_tpu_torch.__main__ import main
from mgn_tpu_torch.checkpoint.manager import load_model
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.synthetic import write_synthetic_tfrecord_dataset
from mgn_tpu_torch.parallel.mesh import rank_device, spawn
from mgn_tpu_torch.train.common import param_leaves
from mgn_tpu_torch.train.strategies import DerivativeTraining
from mgn_tpu_torch.utils.metrics import MetricsLogger

from tests import torch_parallel_support as S

MODEL = dict(mps=2, layer_size=16, hidden_layers=1, seed=0)
KW = {"train": dict(norm_steps=3, checkpoint=5, solver_valid="euler", **MODEL),
      "eval": dict(solver="euler", num_rollouts=1, mse_steps=(1, 3), **MODEL),
      "model": MODEL,
      "cli": ["--mps", "2", "--layer-size", "16", "--hidden-layers", "1", "--seed", "0"]}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("gp_api")
    ds = str(d / "ds")
    write_synthetic_tfrecord_dataset(ds, num_nodes=S.NODES, tl=6, n_train=1, n_valid=1,
                                     n_test=1)
    ranks = spawn(2, S.api_rank, (ds, str(d / "ranks"), KW))
    # the single-device runs
    log = MetricsLogger(quiet=True)
    state, best = mgn_tpu_torch.train_network(
        0.0, lambda ps: torch.optim.Adam(ps, lr=1e-3), ds, str(d / "cp"), device="cpu",
        steps=10, metrics=log, training_strategy=DerivativeTraining(random=False), **KW["train"])
    reports = mgn_tpu_torch.eval_network(ds, str(d / "cp"), str(d / "out"), device="cpu",
                                         **KW["eval"])
    tr = load_dataset(ds, is_training=False).trajectory(0)
    sim = mgn_tpu_torch.simulate(ds, str(d / "cp"), tr.mesh_pos, tr.node_type,
                                 {"velocity": tr.fields["velocity"][0]}, tr.times[:4],
                                 cells=tr.cells, device="cpu", **MODEL)
    cli_cp = str(d / "cp_cli")
    main(["train", ds, cli_cp, "--steps", "5", "--checkpoint", "5", "--norm-steps", "2",
          "--noise", "0", *KW["cli"], "--device", "cpu"])
    single = dict(params=[p.detach().numpy() for p in param_leaves(state.params)], best=best,
                  records=log.records, reports=reports, simulate=sim,
                  cli_params=[p.numpy() for p in param_leaves(
                      load_model(cli_cp, False, torch.device("cpu"))[0])])
    return dict(ranks=ranks, single=single, dir=d)


@pytest.mark.parametrize("form", ["deep", "halo"])
def test_train_network_graph_parallel_matches_single_device(case, form):
    """Ten noise-free steps (two windows, a validation sweep after each):
    the window losses, the best validation loss and the parameters equal the
    single-device run's (rtol 1e-4), the same bits on both ranks."""
    r0, r1 = (r[form] for r in case["ranks"])
    ref = case["single"]
    for a, b in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(r0["params"], ref["params"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r0["best"], ref["best"], rtol=1e-4)
    pick = lambda recs, kind: [x["loss"] for x in recs if x["kind"] == kind]  # noqa: E731
    for kind in ("train", "valid"):
        np.testing.assert_allclose(pick(r0["records"], kind), pick(ref["records"], kind),
                                   rtol=1e-4)
    assert all(x.get("graph_parallel") == 2 for x in r0["records"] if x["kind"] == "train")
    assert r1["records"] == [] or all(x["kind"] != "export" for x in r1["records"])


@pytest.mark.parametrize("form", ["deep", "halo"])
def test_eval_network_graph_parallel_matches_single_device(case, form):
    """eval_network's reports (per-node errors, horizons, final RMSE) equal
    the single-device evaluation's within rtol 1e-4 on every rank; rank 0
    alone writes the export."""
    for r in case["ranks"]:
        got, ref = r[form]["reports"][0], case["single"]["reports"][0]
        np.testing.assert_allclose(got["error"], ref["error"], rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(got["final_rmse"], ref["final_rmse"], rtol=1e-4)
        assert sorted(got["horizons"]) == sorted(ref["horizons"])
    exports = list((case["dir"] / "ranks" / f"out_{form}").glob("*/trajectories.*"))
    assert len(exports) == 1


@pytest.mark.parametrize("form", ["deep", "halo"])
def test_simulate_graph_parallel_matches_single_device(case, form):
    """Every rank returns the whole prediction in the caller's node order,
    the single-device simulate's within rtol 1e-4 (the checkpoint the ranks
    trained, itself within rtol 1e-4 of the single-device one)."""
    ref = case["single"]["simulate"]
    for r in case["ranks"]:
        assert r[form]["simulate"].shape == ref.shape
        np.testing.assert_allclose(r[form]["simulate"], ref, rtol=1e-3, atol=1e-5)


def test_cli_train_and_eval_graph_parallel(case):
    """python -m mgn_tpu_torch train/eval --graph-parallel 2 --dist-backend
    gloo --device cpu, through main(argv) in each rank: the checkpoint
    equals the single-device CLI run's (rtol 1e-4) and eval exports it."""
    for got, want in zip(case["ranks"][0]["cli_params"], case["single"]["cli_params"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert list((case["dir"] / "ranks" / "cli_out").glob("euler/trajectories.*"))


def test_entry_points_reuse_one_mesh_and_its_parts(case):
    """Every entry point call of a rank (two trainings, evaluations and
    simulations, the command line's train and eval) ran on one mesh, whose
    groups were made once; the parts were planned once per exchange (the
    dataset's trajectories share one mesh: deep and classic)."""
    for r in case["ranks"]:
        assert r["meshes"] == 1
        assert r["parts"] == 2


@pytest.fixture(scope="module")
def placed(case):
    return spawn(2, S.device_rank, (str(case["dir"] / "ds"), KW))


@pytest.mark.parametrize("entry", ["train_network", "eval_network", "simulate"])
def test_entry_points_put_the_model_on_the_rank_card(placed, entry):
    """With LOCAL_RANK=k and two cards, each entry point hands cuda:k, the
    mesh's device, to init_state/load_model, after making it the current
    device, so no rank's weights land on cuda:0 beside another rank's
    features."""
    for rank, r in enumerate(placed):
        want = torch.device("cuda", rank)
        assert r[entry] == want
        assert r["mesh"] == want
        assert r["current"] and r["current"][0] == want


def test_device_mesh_without_a_device_takes_the_card(placed):
    """make_device_mesh(device=None) means the rank's card over gloo too:
    without one it raises, as resolve_device does, and never falls back to
    the CPU; one mesh per arguments, and the planner's part of a mesh is
    planned once across planners."""
    for r in placed:
        assert r["no_card"] is not None and "no CUDA device" in r["no_card"]
        assert r["same_mesh"] and r["same_part"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device(None)
    assert rank_device("cpu") == torch.device("cpu")
