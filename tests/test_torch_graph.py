"""Port: core/graph.build_template and data/prep against the JAX package."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from mgn_tpu.core import graph as JG
from mgn_tpu.data.synthetic import make_channel_mesh as jax_channel_mesh
from mgn_tpu_torch.core import graph as TG
from mgn_tpu_torch.data.synthetic import make_channel_mesh

torch.set_num_threads(2)


def _canonical(t):
    """Real-edge order by (receiver, sender): the JAX package's native edge
    builder orders a receiver row by sender, the numpy route does not."""
    s = np.asarray(t.senders)
    r = np.asarray(t.receivers)
    e = int(np.asarray(t.edge_mask).sum())
    order = np.concatenate([np.lexsort((s[:e], r[:e])), np.arange(e, len(s))])
    return order


def _case(kind):
    if kind == "cells":
        pos, cells, nt = make_channel_mesh(100, seed=0)
        return pos, nt, dict(cells=cells)
    if kind == "edges_one_based":
        rng = np.random.default_rng(1)
        pos = rng.random((60, 2)).astype(np.float32)
        edges = np.stack([np.arange(1, 60), np.arange(2, 61)], 1).astype(np.int32)
        return pos, rng.integers(0, 7, 60).astype(np.int32), dict(edges=edges)
    pos, cells, nt = make_channel_mesh(200, seed=3)
    return pos, nt, dict(cells=cells, node_bucket=384, edge_bucket=2048)


@pytest.mark.parametrize("kind", ["cells", "edges_one_based", "explicit_buckets"])
def test_build_template_matches_jax(kind):
    pos, nt, kw = _case(kind)
    ref = JG.build_template(pos, nt, **kw)
    out = TG.build_template(pos, nt, **kw)
    assert out.num_nodes == ref.num_nodes and out.num_edges == ref.num_edges
    for name in ("receivers", "row_offsets", "node_mask", "edge_mask", "node_type",
                 "node_type_onehot"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    o_ref, o_out = _canonical(ref), _canonical(out)
    for name in ("senders", "receivers"):
        np.testing.assert_array_equal(getattr(out, name).numpy()[o_out],
                                      np.asarray(getattr(ref, name))[o_ref], err_msg=name)
    np.testing.assert_allclose(out.mesh_edge_features.numpy()[o_out],
                               np.asarray(ref.mesh_edge_features)[o_ref],
                               rtol=1e-6, atol=1e-7)


def test_padding_contract():
    pos, cells, nt = make_channel_mesh(100, seed=0)
    t = TG.build_template(pos, nt, cells=cells)
    e = int(t.edge_mask.sum())
    n = int(t.node_mask.sum())
    assert (t.senders[e:] == t.num_nodes - 1).all()
    assert (t.receivers[e:] == t.num_nodes - 1).all()
    assert int(t.row_offsets[-1]) == t.num_edges
    assert (t.row_offsets[n:-1] == e).all()
    assert (torch.diff(t.receivers.long()) >= 0).all()
    assert t.senders.dtype == torch.int32 and t.row_offsets.dtype == torch.int32


def test_edge_helpers_match_jax():
    rng = np.random.default_rng(4)
    cells = rng.integers(0, 50, size=(80, 4)).astype(np.int32)
    for a, b in zip(TG.cells_to_edges(cells), JG.cells_to_edges(cells)):
        np.testing.assert_array_equal(a, b)
    s, r = TG.cells_to_edges(cells)
    for a, b in zip(TG.sort_edges_by_receiver(s, r), JG.sort_edges_by_receiver(s, r)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TG.csr_row_offsets(np.sort(r), 50),
                                  JG.csr_row_offsets(np.sort(r), 50))
    assert TG.bucket_size(1901, 128) == JG.bucket_size(1901, 128) == 1920


def test_channel_mesh_is_the_jax_generator():
    for a, b in zip(make_channel_mesh(300, seed=2), jax_channel_mesh(300, seed=2)):
        np.testing.assert_array_equal(a, b)


def test_bad_connectivity_raises():
    pos = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError):
        TG.build_template(pos, np.zeros(4, np.int32), edges=np.array([[0, 7]]))
    with pytest.raises(ValueError):
        TG.build_template(pos, np.zeros(4, np.int32), edges=np.array([[0, 1]]),
                          node_bucket=4)
    with pytest.raises(ValueError):
        TG.build_template(pos, np.zeros(4, np.int32))
