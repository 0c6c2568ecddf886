"""Port: K6's grouped weight-gradient call (ops/fused: ``wgrad_group`` /
``mlp_wgrads``, the plain path on the CPU) against the per-product
``wgrad_plain`` and against ``jax.grad`` of the JAX package's
``apply_mlp_parts``; the host plan the CUDA kernel follows (its blocks
and its fixed-order reduction); and the
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


def _blocks(plan):
    """Every block of the grid decoded as csrc/wgrad.cu's ``decode`` does:
    ``(product, part, tile_a, tile_b, tile, split, first row, end row)``, in
    grid order."""
    for block in range(plan.n_blocks):
        k = max(i for i, p in enumerate(plan.products) if p["block0"] <= block)
        p = plan.products[k]
        tile, split = divmod(block - p["block0"], p["splits"])
        rest, tb = divmod(tile, p["tiles_b"])
        part, ta = divmod(rest, p["tiles_a"])
        r0 = min(split * p["rows_per_block"], p["rows"])
        yield k, part, ta, tb, tile, split, r0, min(r0 + p["rows_per_block"], p["rows"])


def _slot_order(tile):
    """Where a scratch slot's accumulator floats come from in the row-major
    tile (-1: a warp without rows at tile 32): float4 ``(w NI + j) 32 +
    lane`` holds acc[j] of consumer warp w's lane, rows w 16 + lane / 4 and
    8 below it, columns j 8 + 2 (lane % 4) and the next."""
    warps, ni = (8 if tile == 128 else 4), tile // 8
    order = []
    for w in range(warps):
        for j in range(ni):
            for lane in range(32):
                row, col = w * 16 + lane // 4, j * 8 + 2 * (lane % 4)
                for r in (row, row + 8):
                    order += [r * tile + col, r * tile + col + 1] if r < tile else [-1, -1]
    return np.array(order)


def _slot(dw, bias, order):
    """A block's scratch slot: its partial tile in accumulator order, then
    the bias columns."""
    return np.concatenate([np.where(order >= 0, dw.ravel()[np.maximum(order, 0)], 0.0), bias])


def _fixed_order_sum(slots, threads, arrival, counters):
    """The kernel's reduction of one tile over its blocks' partial tiles
    ``slots[split]`` (flat, a whole number of float4 units): blocks finish
    their rows in the order ``arrival`` and count themselves on
    ``counters[0]``; once all have, block ``split`` adds its share of the
    units over the slots in split order — ``tpu`` threads a unit, each
    adding a contiguous range of slots from zero, combined in thread order
    — having counted itself past the wait on ``counters[1]``; the last one
    sets both counters back to 0.  Returns the tile's sum."""
    n = len(slots)
    for block in arrival:  # the slots are written, the first counter counts them
        counters[0] += 1
    assert counters[0] == n  # the blocks wait for this before they read a slot
    units = len(slots[0]) // 4
    per = -(-units // n)
    out = np.zeros_like(slots[0])
    for split in arrival:
        counters[1] += 1
        last = counters[1] == n
        u0 = split * per
        nu = max(0, min(units, u0 + per) - u0)
        tpu = max(1, min(n, threads // max(nu, 1)))
        span = -(-n // tpu)
        for u in range(u0, u0 + nu):
            unit = slice(4 * u, 4 * u + 4)
            parts = []
            for j in range(tpu):
                s = np.zeros(4, slots[0].dtype)
                for i in range(j * span, min(n, (j + 1) * span)):
                    s = s + slots[i][unit]
                parts.append(s)
            total = parts[0]
            for x in parts[1:]:
                total = total + x
            out[unit] = total
        if last:
            counters[0] = counters[1] = 0
    return out


@pytest.mark.parametrize("shapes,tile,blocks", [
    (_round_shapes(300, 3, 32, 2, 5), 32, 8),
    (_round_shapes(60, 2, 64, 1, 30), 64, 132),
    (_round_shapes(11264, 3, 128, 2, 176), 128, 132),  # the cylinder's edge MLP
    (_round_shapes(1920, 2, 128, 2, 120), 128, 132),   # and its node MLP
])
def test_wgrad_plan_covers_every_tile_and_row_once(shapes, tile, blocks):
    """The grid's blocks, decoded as the kernel decodes them, cover every
    (product, part, output tile, row) exactly once and every bias column's
    rows exactly once; the scratch slots of tiles with several blocks and
    their counter pairs lie inside the plan's scratch and counters, one pair
    a tile; and the kernel's reduction of the blocks' partial tiles equals
    the direct product."""
    plan = F.wgrad_plan(shapes, tile, blocks)
    assert plan.n_blocks == sum(max(p["parts"], 1) * p["tiles_a"] * p["tiles_b"] * p["splits"]
                                for p in plan.products) <= blocks
    rng = np.random.default_rng(0)
    covered = [np.zeros((max(p["parts"], 1), p["tiles_a"], p["tiles_b"], p["rows"]), np.int32)
               for p in plan.products]
    data = [(rng.normal(size=(p["rows"], max(p["a_dim"], 1))),
             rng.normal(size=(p["rows"], p["b_dim"]))) for p in plan.products]
    order = _slot_order(tile)
    assert sorted(order[order >= 0]) == list(range(tile * tile))
    size = len(order) + tile  # floats a slot
    partial = {}  # (product, tile) -> [split] -> its scratch slot
    slots, counters = set(), set()
    for k, part, ta, tb, t, split, r0, r1 in _blocks(plan):
        p = plan.products[k]
        assert 0 <= r0 < r1 <= p["rows"] and split < p["splits"]  # no block without rows
        covered[k][part, ta, tb, r0:r1] += 1
        x, dh = data[k]
        cols = slice(tb * tile, (tb + 1) * tile)
        a = slice(ta * tile, (ta + 1) * tile)
        dw = x[r0:r1, a].T @ dh[r0:r1, cols] if p["parts"] else np.zeros((tile, tile))
        partial.setdefault((k, t), [None] * p["splits"])[split] = _slot(
            dw, dh[r0:r1, cols].sum(0), order)
        if p["splits"] > 1:
            slot = p["scratch0"] + (t * p["splits"] + split) * size
            assert 0 <= slot and slot + size <= plan.n_scratch
            slots.add(slot)
            counters.update((p["counter0"] + 2 * t, p["counter0"] + 2 * t + 1))
    assert all((c == 1).all() for c in covered)
    assert len(slots) == plan.n_scratch // size
    assert counters == set(range(plan.n_counters))
    for (k, t), parts in partial.items():
        p = plan.products[k]
        x, dh = data[k]
        rest, tb = divmod(t, p["tiles_b"])
        _, ta = divmod(rest, p["tiles_a"])
        cols = slice(tb * tile, (tb + 1) * tile)
        want = _slot(x[:, ta * tile:(ta + 1) * tile].T @ dh[:, cols] if p["parts"]
                     else np.zeros((tile, tile)), dh[:, cols].sum(0), order)
        counter = [0, 0]
        got = _fixed_order_sum(parts, plan.threads, range(len(parts)), counter)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
        assert counter == [0, 0]


@pytest.mark.parametrize("shapes,tile,blocks,want_blocks", [
    ([(1, 11264, 128, 128)], 128, 132, 118),  # the e part alone: 3 chunks a block
    ([(1, 1920, 128, 128)] * 2, 64, 264, 240),  # the N-row pair: 64-wide tiles, 2 an SM
    (_round_shapes(11264, 1, 128, 2, 176) + [(1, 1920, 128, 128)] * 2, 128, 132, 124),  # defer
    (_round_shapes(1920, 2, 128, 2, 120), 128, 132, 124),  # the node group
    (_round_shapes(300, 3, 32, 2, 5), 32, 8, 7),  # one block a tile
    (_round_shapes(11264, 3, 256, 2, 176), 128, 132, 124),  # 24 tiles
])
def test_wgrad_plan_is_whole_chunks_and_one_wave(shapes, tile, blocks, want_blocks):
    """Blocks take whole chunks, at least _WGRAD_MIN_CHUNKS of them wherever
    a tile has several blocks, and none is left without rows; a group takes
    one wave of the blocks the card holds (the launch is cooperative); a
    block's shared memory fits the card in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = F.wgrad_plan(shapes, tile, blocks, dtype)
        assert plan.n_blocks == want_blocks <= blocks
        assert plan.threads == (384 if tile == 128 else 256)
        assert plan.smem <= 232448
        for p in plan.products:
            per, n = p["rows_per_block"], p["splits"]
            assert per % F._WGRAD_CHUNK == 0 and (n - 1) * per < p["rows"] <= n * per
            assert n == 1 or per >= F._WGRAD_MIN_CHUNKS * F._WGRAD_CHUNK
    tiles = sum(max(p["parts"], 1) * p["tiles_a"] * p["tiles_b"] for p in plan.products)
    with pytest.raises(ValueError, match="holds"):  # more tiles than blocks: no one wave
        F.wgrad_plan(shapes, tile, tiles - 1)


@pytest.mark.parametrize("shapes,tile", [
    ([(1, 11264, 128, 128)], 128),  # the e part
    ([(1, 1920, 128, 128)] * 2, 64),  # the N-row pair: 3,840 tile-rows
    (_round_shapes(1920, 2, 128, 2, 120), 128),  # the node group: 7,920
    (_round_shapes(60, 2, 64, 1, 30), 64),
    (_round_shapes(300, 3, 32, 2, 5), 32),
    ([(1, 300, 96, 96)], 32),
])
def test_wgrad_tile_is_the_widest_that_divides_unless_the_group_is_small(shapes, tile):
    """K6's tile: the widest of 128, 64, 32 dividing every width, but 64
    where a group has fewer than _WGRAD_SMALL rows over its 128-wide tiles;
    a width that is no multiple of 32 is refused."""
    assert F.wgrad_tile(shapes) == tile
    with pytest.raises(ValueError, match="multiples of 32"):
        F.wgrad_tile(shapes + [(1, 10, 48, 32)])


@pytest.mark.parametrize("n", [1, 3, 11, 88])
def test_wgrad_reduction_is_fixed_order(n):
    """The kernel's reduction of a tile over its n blocks — each unit's sum
    split over threads as contiguous ranges of blocks, combined in order —
    equals the direct sum, and in f32 gives the same bits whatever order
    the blocks finish their rows in; the tile's counters are back at 0."""
    rng = np.random.default_rng(n)
    slots = rng.normal(size=(n, len(_slot_order(128)) + 128)) * 10.0 ** rng.integers(
        -3, 4, size=(n, 1))
    counter = [0, 0]
    got = _fixed_order_sum(list(slots), 384, range(n), counter)
    np.testing.assert_allclose(got, slots.sum(axis=0), rtol=1e-9, atol=1e-9)
    bits = None
    for _ in range(3):
        s = _fixed_order_sum(list(slots.astype(np.float32)), 384, rng.permutation(n), counter)
        assert counter == [0, 0] and s.dtype == np.float32
        bits = s if bits is None else bits
        assert np.array_equal(s.view(np.uint32), bits.view(np.uint32))


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
