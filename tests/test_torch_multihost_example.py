"""Port: ``mgn_tpu_torch.examples.multihost_cylinder``, the twin of
``examples/multihost_cylinder/multihost_cylinder.py``, at mesh (1, 2) over
two gloo ranks on the CPU (tests/torch_serve_support.multihost_rank), its
sizes set through its module constants: noise-free, one window of two
updates against the JAX example's step (``make_spmd_derivative_step`` on
the same partition, frames and first parameters, rtol 1e-4); with its own
noise, finite losses the same on both ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mgn_tpu.core import normalizers as JN
from mgn_tpu.core.graph import cells_to_edges
from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.parallel.partition import add_halo_plan, partition_template
from mgn_tpu.parallel.spmd import (batch_from_partitioned, device_put_batch,
                                   make_device_mesh, make_spmd_derivative_step)
from mgn_tpu.train.common import FieldSpec as JaxFieldSpec
from mgn_tpu.train.common import NormState as JaxNormState
from mgn_tpu.train.common import TrainState as JaxTrainState
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.synthetic import write_synthetic_tfrecord_dataset
from mgn_tpu_torch.parallel.mesh import spawn
from mgn_tpu_torch.train.common import param_leaves

from tests import torch_serve_support as S

SIZES = dict(LATENT=16, HIDDEN=1, MPS=4, WINDOW=2)
NOISE_FREE = dict(SIZES, NOISE=0.0, NORM_STEPS=0, FRAMES=2)  # one window, two updates
NOISY = dict(SIZES, NORM_STEPS=1, FRAMES=4)  # the twin's noise, two windows


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multihost"))
    write_synthetic_tfrecord_dataset(path, num_nodes=120, tl=10, n_train=2, n_valid=1,
                                     n_test=1)
    return path


def _jax_window(ds, jparams):
    """The JAX example's first window at NOISE_FREE's sizes: its partition,
    frames (``default_rng(0)``) and step, on mesh (1, 2)."""
    data = load_dataset(ds, is_training=True)
    meta, tr = data.meta, data.trajectory(0)
    spec = JaxFieldSpec.from_meta(meta)
    _, e_norm, n_norms, o_norms = JN.normalizers_from_meta(meta)
    s, r = cells_to_edges(tr.cells)
    pt = add_halo_plan(partition_template(tr.mesh_pos, tr.node_type, s, r, 2))
    batch, bs, _ = batch_from_partitioned([pt], [{f: tr.fields[f] for f in spec.fields}],
                                          [tr.times])
    mesh = make_device_mesh(1, 2)
    opt = optax.adam(1e-4)
    state = JaxTrainState(params=jparams, opt_state=opt.init(jparams),
                          norm=JaxNormState(edge=e_norm, node=n_norms, output=o_norms),
                          step=jnp.zeros((), jnp.int32))
    step = make_spmd_derivative_step(mesh, _jax_cfg(meta), spec, opt, noise_stddevs=(0.0,),
                                     norm_steps=0, boundary_start=bs)
    k = min(NOISE_FREE["WINDOW"], len(tr.times) - 1)
    perms = np.random.default_rng(0).permutation(len(tr.times) - 1)[:k][:, None]
    state, losses = step(state, device_put_batch(mesh, batch.tree()),
                         jnp.asarray(perms, jnp.int32), jax.random.PRNGKey(0))
    return np.asarray(losses), [np.asarray(x) for x in param_leaves(
        jax.tree.map(np.asarray, state.params))]


def _jax_cfg(meta):
    quantities = JN.normalizers_from_meta(meta)[0]
    return JaxMGNConfig(node_input_dim=quantities, edge_input_dim=3,
                        output_dim=JaxFieldSpec.from_meta(meta).output_dim,
                        latent_size=SIZES["LATENT"], hidden_layers=SIZES["HIDDEN"],
                        message_passing_steps=SIZES["MPS"], aggregation_backend="xla")


def test_noise_free_window_matches_the_jax_example(ds):
    meta = load_dataset(ds, is_training=True).meta
    jparams = jax_init_mgn(jax.random.PRNGKey(0), _jax_cfg(meta))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    ranks = spawn(2, S.multihost_rank, (ds, NOISE_FREE, params))
    losses, want = _jax_window(ds, jparams)
    assert ranks[0]["losses"].shape == (1, 2)
    np.testing.assert_allclose(ranks[0]["losses"][0], losses, rtol=1e-4)
    for got, w in zip(ranks[0]["params"], want):
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(ranks[1]["losses"], ranks[0]["losses"])
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        np.testing.assert_array_equal(a, b)


def test_noisy_windows_agree_on_every_rank(ds):
    ranks = spawn(2, S.multihost_rank, (ds, NOISY, None))
    losses = ranks[0]["losses"]
    assert losses.shape == (2, 2) and np.isfinite(losses).all()
    np.testing.assert_array_equal(ranks[1]["losses"], losses)
