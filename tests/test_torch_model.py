"""Port: models/mgn, normalizers, checkpoints, conversion, config and the
fixed-step integrators against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.core import normalizers as JN
from mgn_tpu.core.graph import MeshGraph as JaxMeshGraph
from mgn_tpu.core.graph import build_template as jax_build_template
from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import apply_mgn as jax_apply_mgn
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.rollout.integrators import odeint_fixed as jax_odeint_fixed
from mgn_tpu.train.common import NormState as JaxNormState
from mgn_tpu_torch.checkpoint.manager import CheckpointManager
from mgn_tpu_torch.config import Args
from mgn_tpu_torch.convert import norm_from_jax, params_from_jax
from mgn_tpu_torch.core import normalizers as TN
from mgn_tpu_torch.core.graph import MeshGraph, build_template
from mgn_tpu_torch.data.synthetic import make_channel_mesh
from mgn_tpu_torch.models.mgn import MGNConfig, apply_mgn, init_mgn
from mgn_tpu_torch.rollout.integrators import FIXED_METHODS, odeint_fixed
from mgn_tpu_torch.train.common import TrainState

torch.set_num_threads(2)


def test_apply_mgn_matches_jax():
    pos, cells, nt = make_channel_mesh(100, seed=1)
    jt = jax_build_template(pos, nt, cells=cells)
    tt = build_template(pos, nt, cells=cells)
    cfg = dict(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=32,
               hidden_layers=2, message_passing_steps=3)
    jp = jax_init_mgn(jax.random.PRNGKey(7), JaxMGNConfig(**cfg))
    nf = np.random.default_rng(0).normal(size=(tt.num_nodes, 9)).astype(np.float32)
    ref = jax_apply_mgn(jp, JaxMeshGraph(
        node_features=jnp.asarray(nf), edge_features=jt.mesh_edge_features,
        senders=jt.senders, receivers=jt.receivers, node_mask=jt.node_mask,
        edge_mask=jt.edge_mask), JaxMGNConfig(**cfg), row_offsets=jt.row_offsets)
    out = apply_mgn(params_from_jax(jax.tree.map(np.asarray, jp)), MeshGraph(
        node_features=torch.from_numpy(nf), edge_features=tt.mesh_edge_features,
        senders=tt.senders, receivers=tt.receivers, node_mask=tt.node_mask,
        edge_mask=tt.edge_mask), MGNConfig(**cfg), tt.row_offsets)
    n = int(tt.node_mask.sum())
    assert out.dtype == torch.float32 and tuple(out.shape) == (tt.num_nodes, 2)
    np.testing.assert_allclose(out.numpy()[:n], np.asarray(ref)[:n], rtol=1e-4, atol=1e-5)


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shapes(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _shapes(v, f"{path}/{i}")]
    return [(path, tuple(tree.shape))]


def test_init_mgn_has_the_jax_layout():
    cfg = dict(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=16,
               hidden_layers=2, message_passing_steps=4)
    jp = jax_init_mgn(jax.random.PRNGKey(0), JaxMGNConfig(**cfg))
    tp = init_mgn(MGNConfig(**cfg), torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(tp) == _shapes(jp)
    again = init_mgn(MGNConfig(**cfg), torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again["processor"]["edge_mlp"]["w"][0],
                               tp["processor"]["edge_mlp"]["w"][0], rtol=0, atol=0)


def _jax_norms():
    rng = np.random.default_rng(0)
    online = JN.Online.create(3).update(jnp.asarray(rng.normal(2.0, 3.0, (50, 3)),
                                                    jnp.float32))
    return {"online": online,
            "minmax": JN.OfflineMinMax.create([0.0, -1.0], [2.0, 1.0], -1.0, 1.0),
            "meanstd": JN.OfflineMeanStd.create([1.0, 2.0], [0.5, 4.0])}


@pytest.mark.parametrize("kind", ["online", "minmax", "meanstd"])
def test_normalizers_match_jax(kind):
    jn = _jax_norms()[kind]
    tn = norm_from_jax(JaxNormState(edge=jn, node={}, output={})).edge
    dim = 3 if kind == "online" else 2
    x = np.random.default_rng(1).normal(size=(20, dim)).astype(np.float32)
    np.testing.assert_allclose(tn(torch.from_numpy(x)).numpy(), np.asarray(jn(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.inverse(torch.from_numpy(x)).numpy(),
                               np.asarray(jn.inverse(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_normalizers_from_meta_match_jax():
    from mgn_tpu.data.synthetic import synthetic_meta

    meta = synthetic_meta(5, 1, 1)
    meta["features"]["velocity"].update(output_mean=[0.1, 0.2], output_std=[1.0, 2.0])
    jq, je, jn, jo = JN.normalizers_from_meta(meta)
    tq, te, tn, to = TN.normalizers_from_meta(meta)
    assert jq == tq == 9
    assert type(te).__name__ == type(je).__name__ == "Online"
    assert {k: type(v).__name__ for k, v in tn.items()} == \
        {k: type(v).__name__ for k, v in jn.items()}
    assert type(to["velocity"]).__name__ == "OfflineMeanStd"


def test_checkpoint_roundtrip_and_streams(tmp_path):
    params = init_mgn(MGNConfig(9, 3, 2, 16, 1, 2), torch.Generator().manual_seed(0),
                      device="cpu")
    norm = norm_from_jax(JaxNormState(edge=_jax_norms()["online"],
                                      node={"v": _jax_norms()["meanstd"]}, output={}))
    cm = CheckpointManager(str(tmp_path), keep=2)
    assert cm.restore_model() is None and cm.best_loss() == float("inf")
    for step in (1, 2, 3):
        cm.save(TrainState(params, None, norm, step), loss=float(step))
    cm.save(TrainState(params, None, norm, 2), loss=0.5, best=True)
    assert cm.latest_step() == 3 and cm.latest_step(best=True) == 2
    assert sorted(p for p in tmp_path.iterdir() if p.name.startswith("step_")) == \
        [tmp_path / "step_2", tmp_path / "step_3"]
    assert cm.best_loss() == 0.5
    got = cm.restore_model()
    assert got["step"] == 3
    torch.testing.assert_close(got["params"]["processor"]["node_mlp"]["w"][1],
                               params["processor"]["node_mlp"]["w"][1], rtol=0, atol=0)
    x = torch.randn(4, 3)
    torch.testing.assert_close(got["norm"].edge(x), norm.edge(x), rtol=0, atol=0)
    assert isinstance(got["norm"].node["v"], TN.OfflineMeanStd)


def test_args_keep_every_jax_field():
    from mgn_tpu.config import Args as JaxArgs

    assert [f.name for f in dataclasses.fields(Args)] == \
        [f.name for f in dataclasses.fields(JaxArgs)]
    r = Args(fused=True, unroll=True, aggregation_backend="pallas").resolve_auto()
    assert r.spatial_reorder is False and r.halo_rounds == r.mps


@pytest.mark.parametrize("method", sorted(FIXED_METHODS))
def test_fixed_integrators_match_jax(method):
    a = np.array([[-1.0, 0.5], [-0.3, -0.2]], np.float32)
    y0 = np.array([1.0, -2.0], np.float32)
    saveat = np.array([0.0, 0.1, 0.25, 0.3], np.float32)
    ta = torch.from_numpy(a)
    out = odeint_fixed(lambda y, t: ta @ y + torch.sin(t), torch.from_numpy(y0),
                       torch.from_numpy(saveat), method=method, substeps=2)
    ja = jnp.asarray(a)
    ref = jax_odeint_fixed(lambda y, t: ja @ y + jnp.sin(t), jnp.asarray(y0),
                           jnp.asarray(saveat), method=method, substeps=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
