"""Port: K6's grouped weight-gradient call (ops/fused: ``wgrad_group`` /
``mlp_wgrads``, the plain path on the CPU) against the per-product
``wgrad_plain`` and against ``jax.grad`` of the JAX package's
``apply_mlp_parts``; the host split plan the CUDA kernel follows; and the
LayerNorm partial-sum layouts K4 and K5 write (one row per 64-edge tile,
per 16-node tile)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.models.mlp import apply_mlp_parts as jax_apply_mlp_parts
from mgn_tpu_torch.ops import fused as F
from tests.torch_support import local_graph

torch.set_num_threads(2)

N, E, L = 60, 300, 32
TOL = dict(rtol=5e-4, atol=5e-4)


def _mlp(rng, parts, hidden):
    """Random MLP leaves (numpy f32) with non-trivial biases and LayerNorm."""
    w = [rng.normal(size=(parts * L, L)) / np.sqrt(parts * L)]
    w += [rng.normal(size=(L, L)) / np.sqrt(L) for _ in range(hidden)]
    return {"w": [x.astype(np.float32) for x in w],
            "b": [(0.1 * rng.normal(size=(L,))).astype(np.float32) for _ in range(hidden + 1)],
            "ln_scale": (1 + 0.1 * rng.normal(size=(L,))).astype(np.float32),
            "ln_bias": (0.1 * rng.normal(size=(L,))).astype(np.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def _zeros_like_round(mlp):
    """Gradient stacks of one round (mps = 1) shaped as the MLP's leaves."""
    return {k: ([torch.zeros((1,) + tuple(x.shape)) for x in v] if isinstance(v, list)
                else torch.zeros((1,) + tuple(v.shape))) for k, v in mlp.items()}


def _edge_case(seed, hidden):
    """One edge round's saved quantities (plain K4), its inputs and MLP."""
    rng = np.random.default_rng(seed)
    s, r = local_graph(rng, N, E, spread=10)
    s[-20:], r[-20:] = N - 1, N - 1
    ev = np.ones((E, 1), np.float32)
    ev[-20:] = 0.0
    mlp = _mlp(rng, 3, hidden)
    e = (rng.normal(size=(E, L)) * ev).astype(np.float32)
    v = rng.normal(size=(N, L)).astype(np.float32)
    de = rng.normal(size=(E, L)).astype(np.float32)
    tm = _torch(mlp)
    st, rt = torch.from_numpy(s), torch.from_numpy(r)
    _, _, _, saved = F.edge_round_bwd_plain(_torch(de), torch.zeros((N, L)), _torch(e),
                                            *F.edge_project_plain(_torch(v), tm), st, rt,
                                            _torch(ev), tm)
    inputs = [(_torch(e), None), (_torch(v), st), (_torch(v), rt)]
    return dict(mlp=mlp, tm=tm, saved=saved, inputs=inputs, s=s, r=r, ev=ev, e=e, v=v,
                cot=de)


def _node_case(seed, hidden):
    rng = np.random.default_rng(seed)
    mlp = _mlp(rng, 2, hidden)
    v = rng.normal(size=(N, L)).astype(np.float32)
    agg = rng.normal(size=(N, L)).astype(np.float32)
    dv = rng.normal(size=(N, L)).astype(np.float32)
    tm = _torch(mlp)
    _, _, saved = F.node_round_bwd_plain(_torch(dv), _torch(v), _torch(agg), tm)
    return dict(mlp=mlp, tm=tm, saved=saved, inputs=[(_torch(v), None), (_torch(agg), None)],
                v=v, agg=agg, cot=dv)


CASES = {"edge": _edge_case, "node": _node_case}


@pytest.mark.parametrize("hidden", [1, 2, 3])
@pytest.mark.parametrize("which", ["edge", "node"])
def test_grouped_plain_is_the_per_product_wgrad_plain(which, hidden):
    """One mlp_wgrads call (one grouped K6 call on the card) gives, on the
    CPU, exactly what the per-product plain version gives."""
    c = CASES[which](10 + hidden, hidden)
    grads = _zeros_like_round(c["tm"])
    F.mlp_wgrads(c["saved"], c["inputs"], grads, 0)
    saved = c["saved"]
    dw0 = torch.cat([F.wgrad_plain(saved.dh[0], x, idx)[0] for x, idx in c["inputs"]])
    assert torch.equal(grads["w"][0][0], dw0)
    assert torch.equal(grads["b"][0][0], F.wgrad_plain(saved.dh[0])[1])
    for i in range(1, hidden + 1):
        dw, db = F.wgrad_plain(saved.dh[i], saved.post[i - 1])
        assert torch.equal(grads["w"][i][0], dw)
        assert torch.equal(grads["b"][i][0], db)
    ln = F.wgrad_plain(saved.ln)[1]
    assert torch.equal(grads["ln_scale"][0], ln[:L])
    assert torch.equal(grads["ln_bias"][0], ln[L:])


@pytest.mark.parametrize("hidden", [1, 2, 3])
@pytest.mark.parametrize("which", ["edge", "node"])
def test_grouped_plain_matches_jax_grad_of_apply_mlp_parts(which, hidden):
    """Every weight, bias and LayerNorm gradient of one MLP round from the
    grouped call against jax.grad of mgn_tpu.models.mlp.apply_mlp_parts (the
    edge MLP: three parts, two gathered; the node MLP: two parts)."""
    c = CASES[which](20 + hidden, hidden)
    if which == "edge":
        parts = (jnp.asarray(c["e"]), jnp.asarray(c["v"])[c["s"]], jnp.asarray(c["v"])[c["r"]])
        weight = jnp.asarray(c["cot"]) * jnp.asarray(c["ev"])
    else:
        parts = (jnp.asarray(c["v"]), jnp.asarray(c["agg"]))
        weight = jnp.asarray(c["cot"])
    loss = lambda p: jnp.sum(jax_apply_mlp_parts(p, parts, jnp.float32) * weight)
    ref = jax.grad(loss)(jax.tree.map(jnp.asarray, c["mlp"]))
    grads = _zeros_like_round(c["tm"])
    F.mlp_wgrads(c["saved"], c["inputs"], grads, 0)
    for name in ("w", "b"):
        for got, want in zip(grads[name], ref[name]):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)
    for name in ("ln_scale", "ln_bias"):
        np.testing.assert_allclose(grads[name][0].numpy(), np.asarray(ref[name]), **TOL)


@pytest.mark.parametrize("group_rows", [2, 16])
def test_node_layernorm_groups_match_jax_grad(group_rows, monkeypatch):
    """K5's LayerNorm partial sums, one row per group of node rows (16, K5's
    tile; 2, its earlier warp), reduced through mlp_wgrads give jax.grad's
    LayerNorm gradients of apply_mlp_parts whatever the group size, N not a
    multiple of it included (the last group padded with zeros)."""
    monkeypatch.setattr(F, "_NODE_BWD_ROWS", group_rows)
    c = _node_case(40, 2)
    assert c["saved"].ln.shape == (-(-N // group_rows), 2 * L)
    weight = jnp.asarray(c["cot"])
    loss = lambda p: jnp.sum(jax_apply_mlp_parts(
        p, (jnp.asarray(c["v"]), jnp.asarray(c["agg"])), jnp.float32) * weight)
    ref = jax.grad(loss)(jax.tree.map(jnp.asarray, c["mlp"]))
    grads = _zeros_like_round(c["tm"])
    F.mlp_wgrads(c["saved"], c["inputs"], grads, 0)
    for name in ("ln_scale", "ln_bias"):
        np.testing.assert_allclose(grads[name][0].numpy(), np.asarray(ref[name]), **TOL)


def _round_shapes(rows, parts, latent, hidden, ln_rows):
    """One MLP round's K6 group as mlp_wgrads lays it out."""
    return ([(parts, rows, latent, latent)] + [(1, rows, latent, latent)] * hidden
            + [(0, ln_rows, 0, 2 * latent)])


def _job(plan, job):
    """Pass 1's block ``job`` decoded as csrc/wgrad.cu's wgrad_partial_kernel
    does: ``(product, part, tile_a, tile_b, split, first row, end row)``."""
    k = max(i for i, p in enumerate(plan.products) if p["job0"] <= job)
    p = plan.products[k]
    local, split = divmod(job - p["job0"], p["splits"])
    local, tb = divmod(local, p["tiles_b"])
    part, ta = divmod(local, p["tiles_a"])
    r0 = split * p["rows_per_split"]
    return k, part, ta, tb, split, r0, min(p["rows"], r0 + p["rows_per_split"])


@pytest.mark.parametrize("shapes,tile,sm", [
    (_round_shapes(300, 3, 32, 2, 5), 32, 4),
    (_round_shapes(60, 2, 64, 1, 30), 64, 132),
    (_round_shapes(11264, 3, 128, 2, 176), 64, 132),  # the cylinder's edge MLP
    (_round_shapes(1920, 2, 128, 2, 120), 64, 132),   # and its node MLP
])
def test_wgrad_plan_covers_every_tile_and_row_once(shapes, tile, sm):
    """Pass 1's blocks cover every (product, part, output tile, row) exactly
    once and every bias column's rows exactly once; pass 2's split-ordered
    sum of the partials equals the direct sum."""
    plan = F.wgrad_plan(shapes, tile, sm)
    assert plan.n_jobs == sum(p["splits"] * max(p["parts"], 1) * p["tiles_a"] * p["tiles_b"]
                              for p in plan.products)
    rng = np.random.default_rng(0)
    scratch = np.full(plan.n_scratch, np.nan)
    covered = [np.zeros((max(p["parts"], 1), p["tiles_a"], p["tiles_b"], p["rows"]), np.int32)
               for p in plan.products]
    data = [(rng.normal(size=(p["rows"], max(p["a_dim"], 1))),
             rng.normal(size=(p["rows"], p["b_dim"]))) for p in plan.products]
    for job in range(plan.n_jobs):
        k, part, ta, tb, split, r0, r1 = _job(plan, job)
        p = plan.products[k]
        assert 0 <= r0 < r1 <= p["rows"] and split < p["splits"]
        covered[k][part, ta, tb, r0:r1] += 1
        x, dh = data[k]
        width = p["parts"] * p["a_dim"] * p["b_dim"] + p["b_dim"]
        base = p["scratch0"] + split * width
        cols = slice(tb * tile, (tb + 1) * tile)
        if p["parts"]:  # the tile of x_part^T dh (every part reads the same x here)
            a = slice(ta * tile, (ta + 1) * tile)
            block = x[r0:r1, a].T @ dh[r0:r1, cols]
            out = scratch[base: base + p["parts"] * p["a_dim"] * p["b_dim"]].reshape(
                p["parts"] * p["a_dim"], p["b_dim"])
            out[part * p["a_dim"] + ta * tile: part * p["a_dim"] + (ta + 1) * tile, cols] = block
        if part == 0 and ta == 0:  # the column sums
            bias = scratch[base + p["parts"] * p["a_dim"] * p["b_dim"]:base + width]
            bias[cols] = dh[r0:r1, cols].sum(0)
    assert all((c == 1).all() for c in covered)
    assert not np.isnan(scratch).any()
    for p, (x, dh) in zip(plan.products, data):
        width = p["parts"] * p["a_dim"] * p["b_dim"] + p["b_dim"]
        parts = scratch[p["scratch0"]: p["scratch0"] + p["splits"] * width].reshape(
            p["splits"], width)
        total = np.zeros(width)
        for row in parts:  # in split order, as pass 2 adds them
            total += row
        want = np.concatenate([np.tile((x.T @ dh).ravel(), p["parts"]), dh.sum(0)])
        np.testing.assert_allclose(total, want, rtol=1e-9, atol=1e-9)


def test_wgrad_splits_are_whole_chunks_and_fill_the_card():
    for rows, tiles in ((11264, 12), (11264, 4), (1920, 8), (176, 4), (5, 1), (33, 2)):
        splits, per = F.wgrad_splits(rows, tiles, 132)
        assert per % F._WGRAD_CHUNK == 0
        assert (splits - 1) * per < rows <= splits * per
        assert splits * tiles <= max(2 * 132, tiles)


def test_edge_ln_partials_are_one_row_per_64_edge_tile():
    """K4 writes one LayerNorm partial-sum row per 64-edge tile; the plain
    version lays its partial sums out the same way, and they add up to the
    LayerNorm gradients."""
    assert F._EDGE_BWD_ROWS == 64
    c = _edge_case(7, 2)
    saved = c["saved"]
    assert saved.ln.shape == (-(-E // 64), 2 * L)
    # rebuild [dy * xhat | dy] per edge, through the pre-projected first layer
    # as the plain K4 recomputes it, and group it by tiles of 64 edges
    (e, _), (v, s), (_, r) = c["inputs"]
    extra = F._projected(*F.edge_project_plain(v, c["tm"]), s, r)
    posts, xhat, _ = F._mlp_recompute(c["tm"], [e], torch.float32, extra)
    dy = torch.from_numpy(c["cot"] * c["ev"])
    g = torch.cat([dy * xhat, dy], dim=-1)
    for tile in range(saved.ln.shape[0]):
        torch.testing.assert_close(saved.ln[tile], g[64 * tile: 64 * (tile + 1)].sum(0),
                                   rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(F._ln_partials(dy, xhat, F._EDGE_BWD_ROWS), saved.ln)
