"""Port: models/mlp against the JAX package, f32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.models import mlp as JM
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.models import mlp as TM

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _params(in_dim, out_dim, layer_norm, seed):
    jp = JM.init_mlp(jax.random.PRNGKey(seed), in_dim, 32, 2, out_dim, layer_norm=layer_norm)
    if layer_norm:  # non-trivial LayerNorm parameters
        rng = np.random.default_rng(seed)
        jp["ln_scale"] = jnp.asarray(rng.normal(1.0, 0.2, out_dim), jnp.float32)
        jp["ln_bias"] = jnp.asarray(rng.normal(0.0, 0.2, out_dim), jnp.float32)
    jp["b"] = [jnp.asarray(np.random.default_rng(seed + i).normal(0, 0.1, b.shape),
                           jnp.float32) for i, b in enumerate(jp["b"])]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _check(out, ref, dtype):
    assert out.dtype == DTYPES[dtype][1]
    o = out.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6)
    else:  # one bf16 rounding step flips now and then (2^-8 relative)
        np.testing.assert_allclose(o, r, rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layer_norm", [True, False])
def test_apply_mlp_matches_jax(dtype, layer_norm):
    jp, tp = _params(9, 16, layer_norm, seed=0)
    x = np.random.default_rng(1).normal(size=(64, 9)).astype(np.float32)
    ref = JM.apply_mlp(jp, jnp.asarray(x), DTYPES[dtype][0])
    out = TM.apply_mlp(tp, torch.from_numpy(x), DTYPES[dtype][1])
    _check(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_extra", [False, True])
def test_apply_mlp_parts_matches_jax(dtype, with_extra):
    jp, tp = _params(3 * 32, 32, True, seed=2)
    rng = np.random.default_rng(3)
    parts = [rng.normal(size=(50, 32)).astype(np.float32) for _ in range(3)]
    extra = rng.normal(size=(50, 32)).astype(np.float32) if with_extra else None
    ref = JM.apply_mlp_parts(jp, [jnp.asarray(p) for p in parts], DTYPES[dtype][0],
                             extra=None if extra is None else jnp.asarray(extra))
    out = TM.apply_mlp_parts(tp, [torch.from_numpy(p) for p in parts], DTYPES[dtype][1],
                             extra=None if extra is None else torch.from_numpy(extra))
    _check(out, ref, dtype)


def test_init_mlp_layout_and_range():
    p = TM.init_mlp(10, 32, 2, 4, layer_norm=True, generator=torch.Generator().manual_seed(0))
    assert [tuple(w.shape) for w in p["w"]] == [(10, 32), (32, 32), (32, 4)]
    assert [tuple(b.shape) for b in p["b"]] == [(32,), (32,), (4,)]
    assert all(float(b.abs().max()) == 0.0 for b in p["b"])
    assert float(p["w"][0].abs().max()) <= np.sqrt(6.0 / 42)
    assert tuple(p["ln_scale"].shape) == (4,)
    jp = JM.init_mlp(jax.random.PRNGKey(0), 10, 32, 2, 4)
    assert sorted(jp) == sorted(p)


def test_parts_must_cover_the_weight():
    p = TM.init_mlp(64, 32, 1, 32)
    with pytest.raises(ValueError):
        TM.apply_mlp_parts(p, [torch.zeros(3, 32)])
