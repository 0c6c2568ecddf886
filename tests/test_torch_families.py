"""Port: the Airfoil (two targets: velocity 2 + density 1, per-field noise)
and DeformingPlate (3-D structured grid without cells, ``absolute`` stress
head, types_updated (0, 6)) families against the JAX package on the CPU, at
``tests/test_families.py``'s small settings.

The JAX package writes each family to HDF5, the port to TFRecord, from the
same seed: the arrays are equal bit for bit, and the plate's grid, stored as
cells of width 2, gives the template of the JAX package's HDF5 plate (whose
reader synthesises the grid's edges).  From a JAX-trained checkpoint
converted with ``mgn_tpu_torch.convert`` the evaluation reports and
predictions agree within rtol/atol 1e-4, and three noise-free training steps
from the same weights give losses within rtol 1e-3.  Also the training
noise's statistics (ROADMAP C6): per noisy type and per field, mean 0 and
standard deviation sigma within a sampling bound; exactly 0 elsewhere."""


import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgn_tpu.api import eval_network as jax_eval_network
from mgn_tpu.api import init_state as jax_init_state
from mgn_tpu.api import train_network as jax_train_network
from mgn_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from mgn_tpu.config import Args as JaxArgs
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.prep import common_buckets as jax_common_buckets
from mgn_tpu.data.prep import prepare_trajectory as jax_prepare_trajectory
from mgn_tpu.data.synthetic import write_airfoil_dataset, write_plate_dataset
from mgn_tpu.train.derivative import DerivativeTrainerConfig as JaxTrainerConfig
from mgn_tpu.train.derivative import make_derivative_trainer as jax_make_trainer
import mgn_tpu_torch
from mgn_tpu_torch.api import build_model_config
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax, save_checkpoint_from_jax
from mgn_tpu_torch.core.graph import build_template
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.prep import prepare_trajectory
from mgn_tpu_torch.data.synthetic import (write_airfoil_tfrecord_dataset,
                                          write_plate_tfrecord_dataset)
from mgn_tpu_torch.models.mgn import init_mgn
from mgn_tpu_torch.train.common import TrainState, param_leaves, type_mask
from mgn_tpu_torch.train.derivative import (DerivativeTrainerConfig, frame_inputs,
                                            make_derivative_trainer)

torch.set_num_threads(2)

SMALL = dict(mps=2, layer_size=16, hidden_layers=1)
TOL = dict(rtol=1e-4, atol=1e-4)
COUNTS = dict(n_train=2, n_valid=1, n_test=1)
# family -> (JAX HDF5 writer, port TFRecord writer, their arguments, Args, the
# training noise of tests/test_families.py, decoder width)
FAMILIES = {
    "airfoil": (write_airfoil_dataset, write_airfoil_tfrecord_dataset,
                dict(num_nodes=48, tl=8, seed=1), dict(types_updated=(0, 5)), (0.01, 0.001), 3),
    "plate": (write_plate_dataset, write_plate_tfrecord_dataset,
              dict(dims=(4, 4, 3), tl=6, seed=1), dict(types_updated=(0, 6)), 0.003, 4),
}
_WRITTEN = {}


def _family(name, tmp_path_factory):
    """The family's two datasets (JAX HDF5, port TFRecord), written once."""
    if name not in _WRITTEN:
        jax_writer, port_writer, kw, args, noise, width = FAMILIES[name]
        root = tmp_path_factory.mktemp(name)
        jax_ds, port_ds = str(root / "h5"), str(root / "tfrecord")
        jax_writer(jax_ds, **kw, **COUNTS)
        port_writer(port_ds, **kw, **COUNTS)
        _WRITTEN[name] = dict(name=name, root=root, jax_ds=jax_ds, port_ds=port_ds, args=args,
                              noise=noise, width=width)
    return _WRITTEN[name]


@pytest.fixture(scope="module", params=list(FAMILIES))
def fam(request, tmp_path_factory):
    return _family(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    return _family("plate", tmp_path_factory)


def _splits(ds):
    return [(True, i, False) for i in range(ds.num_trajectories)] + \
        [(True, i, True) for i in range(ds.num_valid)]


def test_datasets_are_the_jax_packages_bit_for_bit(fam):
    for is_training in (True, False):
        port = load_dataset(fam["port_ds"], is_training)
        ref = jax_load_dataset(fam["jax_ds"], is_training)
        assert (port.num_trajectories, port.num_valid) == (ref.num_trajectories, ref.num_valid)
        for _, i, valid in _splits(port):
            a, b = port.trajectory(i, valid=valid), ref.trajectory(i, valid=valid)
            assert sorted(a.fields) == sorted(b.fields)
            for f in a.fields:
                assert a.fields[f].dtype == b.fields[f].dtype == np.float32
                np.testing.assert_array_equal(a.fields[f], b.fields[f], err_msg=f)
            for name in ("mesh_pos", "node_type", "times"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
            if fam["name"] == "airfoil":
                np.testing.assert_array_equal(a.cells, b.cells)
            else:  # the grid: pairs as cells in the TFRecord, edges from the HDF5 reader
                assert a.cells.shape[1] == 2 and b.cells is None and b.edges is not None


def _rows(t):
    s, r, e = t.senders, t.receivers, int(np.asarray(t.edge_mask).sum())
    rows = [set() for _ in range(t.num_nodes)]
    for a, b in zip(np.asarray(s)[:e].tolist(), np.asarray(r)[:e].tolist()):
        rows[b].add(a)
    return rows


def test_plate_template_is_the_jax_hdf5_plates(plate):
    """The port's template of the TFRecord plate: the JAX package's template of
    its HDF5 plate — the same edge set in every row, and bit for bit (both
    native graph builders load)."""
    a = load_dataset(plate["port_ds"]).trajectory(0)
    b = jax_load_dataset(plate["jax_ds"]).trajectory(0)
    port = build_template(a.mesh_pos, a.node_type, cells=a.cells, edges=a.edges)
    ref = jax_build_template(b.mesh_pos, b.node_type, cells=b.cells, edges=b.edges)
    assert port.num_nodes == ref.num_nodes == 128 and int(port.edge_mask.sum()) == 208
    assert _rows(port) == _rows(ref)
    for name in ("senders", "receivers", "row_offsets", "mesh_edge_features"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_jax_reader_reads_the_port_plate_to_the_same_graph(plate):
    a = jax_load_dataset(plate["port_ds"]).trajectory(1)
    b = jax_load_dataset(plate["jax_ds"]).trajectory(1)
    ta = jax_build_template(a.mesh_pos, a.node_type, cells=a.cells, edges=a.edges)
    tb = jax_build_template(b.mesh_pos, b.node_type, cells=b.cells, edges=b.edges)
    for name in ("senders", "receivers", "row_offsets", "mesh_edge_features"):
        np.testing.assert_array_equal(np.asarray(getattr(ta, name)),
                                      np.asarray(getattr(tb, name)), err_msg=name)
    for f in b.fields:
        np.testing.assert_array_equal(a.fields[f], b.fields[f])


def test_decoder_output_width(fam):
    meta = load_dataset(fam["port_ds"]).meta
    cfg, spec = build_model_config(meta, Args(**SMALL))
    assert cfg.output_dim == spec.output_dim == fam["width"]
    assert spec.output_modes == (("delta", "delta") if fam["name"] == "airfoil"
                                 else ("delta", "absolute"))
    assert cfg.edge_input_dim == (3 if fam["name"] == "airfoil" else 4)
    params = init_mgn(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["decoder"]["w"][-1].shape == (16, fam["width"])
    jstate, jcfg, _ = jax_init_state(jax_load_dataset(fam["jax_ds"]).meta,
                                     JaxArgs(**SMALL).resolve_auto(), optax.sgd(1.0))
    assert jstate.params["decoder"]["w"][-1].shape == (16, fam["width"])


@pytest.fixture(scope="module")
def trained(fam):
    """A 6-step JAX training run on the family's HDF5 dataset (normalizers
    warmed over 3 steps) and its checkpoint converted for the port."""
    root = fam["root"]
    jax_cp, torch_cp = str(root / "cp_jax"), str(root / "cp_torch")
    run = dict(steps=6, norm_steps=3, checkpoint=100, seed=0, solver_valid="euler",
               **SMALL, **fam["args"])
    jax_train_network(fam["noise"], optax.adam(1e-3), fam["jax_ds"], jax_cp, **run)
    meta = jax_load_dataset(fam["jax_ds"]).meta
    state, _, _ = jax_init_state(meta, JaxArgs(**run).resolve_auto(), optax.sgd(1.0))
    manager = JaxCheckpointManager(jax_cp)
    model = manager.restore_model(JaxCheckpointManager.model_subtree(state))
    save_checkpoint_from_jax(jax.tree.map(np.asarray, model), torch_cp)
    return jax_cp, torch_cp


def test_eval_from_a_converted_jax_checkpoint_matches_jax(fam, trained, tmp_path):
    jax_cp, torch_cp = trained
    kw = dict(solver="euler", mse_steps=(1, 3), **SMALL, **fam["args"])
    ref = jax_eval_network(fam["jax_ds"], jax_cp, str(tmp_path / "jax"), **kw)
    got = mgn_tpu_torch.eval_network(fam["port_ds"], torch_cp, str(tmp_path / "port"),
                                     device="cpu", **kw)
    assert len(got) == len(ref) == 1
    for g, r in zip(got, ref):
        assert list(g["horizons"]) == list(r["horizons"]) == [1, 3]
        for k, h in r["horizons"].items():
            for name in ("mse", "cum_mse", "cum_rmse"):
                np.testing.assert_allclose(g["horizons"][k][name], h[name], **TOL)
        np.testing.assert_allclose(g["mse_t"], np.asarray(r["mse_t"]), **TOL)
        np.testing.assert_allclose(g["final_rmse"], r["final_rmse"], **TOL)
    with h5py.File(str(tmp_path / "port" / "euler" / "trajectories.h5"), "r") as a, \
            h5py.File(str(tmp_path / "jax" / "euler" / "trajectories.h5"), "r") as b:
        # the port's plate has the grid pairs as cells, the JAX HDF5 plate no cells
        assert sorted(set(a["0"]) - {"cells"}) == sorted(set(b["0"]) - {"cells"})
        assert ("cells" in b["0"]) == (fam["name"] == "airfoil") and "cells" in a["0"]
        np.testing.assert_array_equal(np.asarray(a["0"]["mesh_pos"]),
                                      np.asarray(b["0"]["mesh_pos"]))
        pred = np.asarray(a["0"]["prediction"])
        assert pred.shape[-1] == fam["width"] and np.isfinite(pred).all()
        np.testing.assert_allclose(pred, np.asarray(b["0"]["prediction"]), **TOL)
        np.testing.assert_array_equal(np.asarray(a["0"]["gt"]), np.asarray(b["0"]["gt"]))


def test_three_noise_free_steps_match_jax(fam):
    """Three steps of the derivative trainer from the same initial weights,
    noise 0, the first a normalizer warm-up: losses within rtol 1e-3."""
    jds = jax_load_dataset(fam["jax_ds"])
    meta = jds.meta
    args = JaxArgs(seed=0, norm_steps=1, **SMALL, **fam["args"]).resolve_auto()
    opt = optax.adam(1e-3)
    jstate, jcfg, jspec = jax_init_state(meta, args, opt)
    nb, eb = jax_common_buckets([jds.trajectory(0)], meta)
    jprep = jax_prepare_trajectory(jds.trajectory(0), meta, jspec, nb, eb)
    perm = [3, 0, 4]
    zero = (0.0,) * len(jspec.target_fields)
    jtrain = jax.jit(jax_make_trainer(JaxTrainerConfig(
        model=jcfg, spec=jspec, noise_stddevs=zero, norm_steps=1,
        types_updated=fam["args"]["types_updated"]), opt))
    _, jlosses = jtrain(jstate, jprep.template, jprep.fields, jprep.times,
                        jnp.asarray(perm, jnp.int32), jax.random.PRNGKey(0))

    port_meta = load_dataset(fam["port_ds"]).meta
    cfg, spec = build_model_config(port_meta, Args(**SMALL))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for p in param_leaves(params):
        p.requires_grad_(True)
    state = TrainState(params, torch.optim.Adam(param_leaves(params), lr=1e-3),
                       norm_from_jax(jax.tree.map(np.asarray, jstate.norm)), 0)
    prep = prepare_trajectory(load_dataset(fam["port_ds"]).trajectory(0), port_meta, spec,
                              nb, eb)
    train = make_derivative_trainer(DerivativeTrainerConfig(
        cfg, spec, zero, types_updated=fam["args"]["types_updated"], norm_steps=1))
    state, losses = train(state, prep.template, prep.fields, prep.times, perm,
                          torch.Generator().manual_seed(0))
    assert state.step == 3 and np.isfinite(losses.numpy()).all()
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-3)


# --- ROADMAP C6: the training noise's statistics ------------------------------

DRAWS = 400


@pytest.mark.parametrize("name,sigmas,types_noisy", [
    ("plate", (0.003,), (0, 6)),  # one sigma for both targets
    ("airfoil", (10.0, 0.01), (0, 1)),  # the airfoil example's per-field noise
])
def test_training_noise_has_the_configured_statistics(tmp_path_factory, name, sigmas,
                                                      types_noisy):
    """Many draws of frame_inputs on the family's template: per noisy node
    type and per target field, the noise's mean is 0 within 5 standard
    errors (5 sigma / sqrt(n)) and its standard deviation sigma within
    5 / sqrt(2 (n - 1)) relative (the normal approximation of the sample
    standard deviation's spread); nodes of other types and padded rows get
    exactly 0."""
    fam = _family(name, tmp_path_factory)
    meta = load_dataset(fam["port_ds"]).meta
    cfg, spec = build_model_config(meta, Args(**SMALL))
    prep = prepare_trajectory(load_dataset(fam["port_ds"]).trajectory(0), meta, spec)
    tm = prep.template
    tcfg = DerivativeTrainerConfig(cfg, spec, sigmas, types_noisy=types_noisy)
    noisy = type_mask(tm.node_type, types_noisy) & tm.node_mask
    gen = torch.Generator().manual_seed(5)
    draws = {f: [] for f in spec.target_fields}
    for k in range(DRAWS):
        u, _ = frame_inputs(tcfg, prep.fields, prep.times, k % 3, noisy, gen)
        for f in spec.target_fields:
            draws[f].append(u[f] - prep.fields[f][k % 3])
    checked = 0
    for i, f in enumerate(spec.target_fields):
        noise = torch.stack(draws[f]).double()  # (draws, N_pad, dim)
        sigma = tcfg.sigma(i)
        assert (noise[:, ~noisy] == 0).all(), f
        for t in types_noisy:
            rows = (tm.node_type == t) & tm.node_mask
            if not rows.any():
                continue
            x = noise[:, rows].reshape(-1)
            n = x.numel()
            assert abs(float(x.mean())) <= 5 * sigma / np.sqrt(n), (f, t)
            assert abs(float(x.std()) / sigma - 1) <= 5 / np.sqrt(2 * (n - 1)), (f, t)
            checked += 1
    assert checked >= len(spec.target_fields)
