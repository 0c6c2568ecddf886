"""Port: the plain CSR segment-sum (K1's plain version) and ops/segment
against the JAX package's Pallas ``csr_segment_sum`` in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.ops.pallas_segment import csr_segment_sum as jax_csr_segment_sum
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_plain
from mgn_tpu_torch.ops.segment import csr_order, gather, segment_sum
from tests.torch_support import csr_case

torch.set_num_threads(2)

CASES = {
    # n_real, n_pad, e_real, e_pad, f, hub
    "padded_tail": (100, 128, 700, 768, 128, None),
    "no_padding": (128, 128, 768, 768, 128, None),
    "mostly_empty_rows": (5, 256, 17, 512, 8, None),
    "high_degree_node": (200, 256, 1200, 1536, 16, (37, 300)),
}


def _assert_same_sums(out, ref, data, recv, row):
    """The two sum each row's edges in another grouping; f32 rounding then
    differs by at most 2 (deg - 1) u sum|x| per entry (u = 2^-24), which the
    long rows (the hub, the dead-edge trash row) come near."""
    deg = np.diff(row).astype(np.float64)[:, None]
    abs_sum = np.zeros(out.shape, np.float64)
    np.add.at(abs_sum, recv, np.abs(data).astype(np.float64))
    bound = 2 * np.maximum(deg - 1, 0) * 2.0 ** -24 * abs_sum
    assert (np.abs(out.astype(np.float64) - ref) <= bound).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_interpret(case):
    n_real, n_pad, e_real, e_pad, f, hub = CASES[case]
    data, recv, row = csr_case(np.random.default_rng(1), n_real, n_pad, e_real, e_pad, f, hub)
    ref = jax_csr_segment_sum(jnp.asarray(data), jnp.asarray(recv), jnp.asarray(row),
                              n_pad, block_nodes=128, block_edges=256, interpret=True)
    out = csr_segment_sum(torch.from_numpy(data), torch.from_numpy(recv),
                          torch.from_numpy(row), n_pad)
    assert out.dtype == torch.float32 and tuple(out.shape) == (n_pad, f)
    _assert_same_sums(out.numpy(), np.asarray(ref), data, recv, row)
    assert not out.numpy()[np.diff(row) == 0].any()  # empty rows are exactly zero


def test_plain_bf16_accumulates_in_f32():
    data, recv, row = csr_case(np.random.default_rng(2), 100, 128, 700, 768, 32)
    ref = jax_csr_segment_sum(jnp.asarray(data, jnp.bfloat16), jnp.asarray(recv),
                              jnp.asarray(row), 128, interpret=True)
    data_bf16 = torch.from_numpy(data).to(torch.bfloat16)
    out = csr_segment_sum_plain(data_bf16, torch.from_numpy(recv), torch.from_numpy(row), 128)
    assert out.dtype == torch.float32
    _assert_same_sums(out.numpy(), np.asarray(ref), data_bf16.float().numpy(), recv, row)


def test_gradient_is_row_gather():
    data, recv, row = csr_case(np.random.default_rng(3), 100, 128, 700, 768, 8)
    d = torch.from_numpy(data).requires_grad_(True)
    out = csr_segment_sum(d, torch.from_numpy(recv), torch.from_numpy(row), 128)
    (out ** 2).sum().backward()
    expect = 2 * out.detach().numpy()[recv]
    np.testing.assert_allclose(d.grad.numpy(), expect, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", [None, "auto", "xla", "pallas", "banded"])
@pytest.mark.parametrize("with_offsets", [True, False])
def test_segment_sum_dispatch(backend, with_offsets):
    data, recv, row = csr_case(np.random.default_rng(4), 100, 128, 700, 768, 16)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(recv), 128))
    out = segment_sum(torch.from_numpy(data), torch.from_numpy(recv), 128,
                      row_offsets=torch.from_numpy(row) if with_offsets else None,
                      backend=backend)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_segment_sum_rejects_unsorted_and_unknown():
    """Unknown backends raise, for sorted and unsorted ids; so do CSR
    ``row_offsets`` given with unsorted ids, which they cannot describe."""
    data = torch.arange(16.0).reshape(4, 4)
    ids = torch.tensor([2, 0, 1, 0], dtype=torch.int32)
    with pytest.raises(ValueError):
        segment_sum(data, ids, 3, backend="onehot")
    with pytest.raises(ValueError):
        segment_sum(data, ids, 3, indices_are_sorted=False, backend="onehot")
    with pytest.raises(ValueError, match="row_offsets"):
        segment_sum(data, ids, 3, row_offsets=torch.tensor([0, 2, 3, 4], dtype=torch.int32),
                    indices_are_sorted=False)


def test_segment_sum_sums_unsorted_ids():
    """Unsorted ids are summed in a stable order by id (K1's permutation
    path on a CUDA tensor)."""
    data = torch.arange(16.0).reshape(4, 4)
    ids = torch.tensor([2, 0, 1, 0], dtype=torch.int32)
    out = segment_sum(data, ids, 3, indices_are_sorted=False)
    assert torch.equal(out, torch.zeros(3, 4).index_add_(0, ids, data))


def test_csr_order_puts_invalid_rows_in_no_segment():
    """Rows marked invalid sort after the last offset: the permutation sum
    never reads them, and the valid rows give the scatter-add's sums."""
    rng = np.random.default_rng(6)
    n, e, f = 40, 300, 8
    ids = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    valid = torch.from_numpy(rng.random(e) < 0.6)
    ids = torch.where(valid, ids, torch.zeros_like(ids))  # dead rows point at node 0
    data = torch.from_numpy(rng.normal(size=(e, f)).astype(np.float32))
    perm, offsets = csr_order(ids, n, valid)
    assert perm.dtype == offsets.dtype == torch.int32 and tuple(offsets.shape) == (n + 1,)
    assert int(offsets[-1]) == int(valid.sum())
    assert sorted(perm[int(offsets[-1]):].tolist()) == torch.nonzero(~valid).flatten().tolist()
    assert torch.equal(ids[perm[:int(offsets[-1])].long()],
                       torch.sort(ids[valid]).values)
    poisoned = torch.where(valid[:, None], data, torch.full_like(data, float("nan")))
    out = csr_segment_sum(poisoned, ids, offsets, n, perm=perm)
    ref = torch.zeros((n, f)).index_add_(0, ids[valid].long(), data[valid])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_gather_matches_take():
    x = np.random.default_rng(5).normal(size=(20, 8)).astype(np.float32)
    idx = np.array([3, 0, 19, 3], np.int32)
    np.testing.assert_array_equal(gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
                                  np.asarray(jnp.take(jnp.asarray(x), idx, axis=0)))


def test_meta_device_raises():
    with pytest.raises(ValueError):
        csr_segment_sum(torch.zeros(4, 4, device="meta"), torch.zeros(4, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int32), 2)
