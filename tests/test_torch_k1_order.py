"""Port: K1's fixed summation order in its plain version.

Row n's entries, in CSR order, are cut into chunks of ``CHUNK`` entries
counted from the row's start; each chunk is summed left to right from zero
in f32 and the row's value is its chunk sums added left to right from zero
(``mgn_tpu_torch/ops/csr_segment.py``).  The CUDA kernel keeps the same
order, and ``tests/test_torch_kernels.py`` holds it to these bits on the
card; here the plain version is held to an explicit loop, to the single
``index_add_`` it replaced on every row of at most ``CHUNK`` entries, and to
the JAX package's Pallas kernel in interpret mode."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.ops.pallas_segment import csr_segment_sum as jax_csr_segment_sum
from mgn_tpu_torch.ops.csr_segment import CHUNK, csr_segment_sum, csr_segment_sum_plain
from mgn_tpu_torch.ops.segment import csr_order
from mgn_tpu_torch.probes import k1_split
from tests.torch_support import csr_case

torch.set_num_threads(2)

F = 24


def _loop(data, offsets, perm=None):
    """The fixed order written out: chunk sums from zero, then the row from
    zero, one f32 add at a time."""
    n = offsets.numel() - 1
    out = torch.zeros((n, data.shape[1]))
    o = offsets.tolist()
    for r in range(n):
        row = torch.zeros(data.shape[1])
        for c0 in range(o[r], o[r + 1], CHUNK):
            s = torch.zeros(data.shape[1])
            for j in range(c0, min(c0 + CHUNK, o[r + 1])):
                s = s + data[j if perm is None else int(perm[j])].float()
            row = row + s
        out[r] = row
    return out


def _case(length, dtype, rng):
    """Rows of 2, ``length``, 0 and 1 entries, then a row left out past
    ``offsets[-1]``; data of mixed magnitudes, so any other grouping moves
    the last bits."""
    lengths = [2, length, 0, 1]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32)
    e = int(offsets[-1]) + 3
    data = rng.normal(size=(e, F)) * 10.0 ** rng.integers(-3, 4, size=(e, 1))
    return torch.from_numpy(data.astype(np.float32)).to(dtype), offsets


LENGTHS = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK, 2 * CHUNK + 1, 5 * CHUNK + 3]


@pytest.mark.parametrize("form", ["identity", "perm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("length", LENGTHS)
def test_plain_equals_the_chunk_loop(length, dtype, form):
    rng = np.random.default_rng(length)
    data, offsets = _case(length, dtype, rng)
    perm = None
    if form == "perm":
        perm = torch.from_numpy(rng.permutation(data.shape[0]).astype(np.int32))
    ids = torch.repeat_interleave(torch.arange(4), torch.diff(offsets.long()))
    out = csr_segment_sum_plain(data, ids, offsets, 4, perm=perm)
    assert out.dtype == torch.float32
    assert torch.equal(out, _loop(data, offsets, perm))
    # the CPU wrapper is the plain version, and its out= form the same bits
    buf = torch.full((4, F), float("nan"))
    assert torch.equal(csr_segment_sum(data, ids, offsets, 4, perm=perm, out=buf), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["cylinder", "flag"])
def test_single_chunk_rows_keep_the_index_add_bits(name, dtype):
    """Every row of the templates but the trash row is one chunk, so it keeps
    the bits of the one ``index_add_`` over receivers the plain version was;
    the trash row is summed chunk by chunk, within the summation bound."""
    x = k1_split.templates()[name]
    offsets, (perm, send) = x["k1"], x["perm"]
    n, e = x["n"], x["e"]
    data = torch.from_numpy(np.random.default_rng(3).normal(size=(e, 64)).astype(
        np.float32)).to(dtype)
    deg = torch.diff(offsets.long())
    assert int(deg[:-1].max()) <= CHUNK < int(deg[-1])
    recv = torch.repeat_interleave(torch.arange(n), deg)
    out = csr_segment_sum_plain(data, recv, offsets, n)
    old = torch.zeros((n, 64)).index_add_(0, recv, data.float())
    assert torch.equal(out[:-1], old[:-1])
    bound = 2 * (deg[-1] - 1) * 2.0 ** -24 * data.float().abs().sum(0)
    assert ((out[-1] - old[-1]).abs() <= bound).all()
    # the sender side, through the permutation
    sdeg = torch.diff(send.long())
    sids = torch.repeat_interleave(torch.arange(n), sdeg)
    out = csr_segment_sum_plain(data, sids, send, n, perm=perm)
    old = torch.zeros((n, 64)).index_add_(0, sids, data.index_select(0, perm.long()).float())
    assert torch.equal(out[:-1], old[:-1])


def test_plain_without_offsets_chunks_each_segment_in_data_order():
    """``row_offsets=None`` (the plain processor's form): each segment's rows
    in their order in ``data``, chunked from the segment's first row, also
    where the ids are not sorted."""
    rng = np.random.default_rng(8)
    ids = torch.from_numpy(rng.integers(0, 5, size=300).astype(np.int32))
    data = torch.from_numpy(rng.normal(size=(300, F)).astype(np.float32))
    perm, offsets = csr_order(ids, 5)
    out = csr_segment_sum_plain(data, ids, None, 5)
    assert torch.equal(out, _loop(data, offsets, perm))


def test_plain_matches_jax_interpret_on_a_5000_entry_row():
    """A 5,000-entry row summed chunk by chunk stays within
    ``test_plain_matches_jax_interpret``'s bound of the JAX Pallas kernel,
    2 (deg - 1) u sum|x| an entry."""
    data, recv, row = csr_case(np.random.default_rng(9), 200, 256, 6000, 6144, 16, (37, 5000))
    assert int(np.diff(row)[37]) >= 5000
    ref = np.asarray(jax_csr_segment_sum(jnp.asarray(data), jnp.asarray(recv), jnp.asarray(row),
                                         256, block_nodes=128, block_edges=256,
                                         interpret=True))
    out = csr_segment_sum_plain(torch.from_numpy(data), torch.from_numpy(recv),
                                torch.from_numpy(row), 256).numpy()
    deg = np.diff(row).astype(np.float64)[:, None]
    abs_sum = np.zeros(out.shape, np.float64)
    np.add.at(abs_sum, recv, np.abs(data).astype(np.float64))
    bound = 2 * np.maximum(deg - 1, 0) * 2.0 ** -24 * abs_sum
    assert (np.abs(out.astype(np.float64) - ref) <= bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_csr_order_rows_outside_valid_are_never_read(dtype):
    """``csr_order`` sorts the rows ``valid`` leaves out past the last
    offset; NaN in them never reaches a sum, and the rest is the loop's."""
    rng = np.random.default_rng(10)
    n, e = 30, 700
    ids = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    ids[:100] = 4  # one row of several chunks
    valid = torch.from_numpy(rng.random(e) < 0.7)
    data = torch.from_numpy(rng.normal(size=(e, F)).astype(np.float32)).to(dtype)
    poisoned = torch.where(valid[:, None], data, torch.full_like(data, float("nan")))
    perm, offsets = csr_order(ids, n, valid)
    out = csr_segment_sum_plain(poisoned, ids, offsets, n, perm=perm)
    assert torch.isfinite(out).all()
    assert int(torch.diff(offsets)[4]) > 2 * CHUNK
    assert torch.equal(out, _loop(data, offsets, perm))


def test_k1_split_empties_only_the_trash_row():
    """The split's inputs: the templates' trash rows (222 at the cylinder,
    966 at the flag, longest real rows 11 and 6), and the emptied form that
    changes nothing but the last offset, on both CSRs."""
    t = k1_split.templates()
    assert {k: (x["n"], x["e"]) for k, x in t.items()} == {
        "cylinder": (1920, 11264), "emptied": (1920, 11264), "flag": (1664, 10240)}
    assert k1_split._row_stats(t["cylinder"]["k1"]) == (222, 11)
    assert k1_split._row_stats(t["flag"]["k1"]) == (966, 6)
    for form in ("k1", "perm"):
        full = t["cylinder"][form] if form == "k1" else t["cylinder"][form][1]
        cut = t["emptied"][form] if form == "k1" else t["emptied"][form][1]
        assert torch.equal(full[:-1], cut[:-1]) and int(cut[-1]) == int(cut[-2])
        assert k1_split._row_stats(cut) == (0, 11)


def test_kernel_source_sums_in_the_wrappers_chunk():
    """``csrc/csr_segment.cu``'s ``kChunk`` is the wrapper's ``CHUNK``, the
    length the plain version chunks by (the C function refuses any other)."""
    with open(os.path.join(k1_split._CSRC, "csr_segment.cu")) as fh:
        found = re.findall(r"constexpr int kChunk = (\d+);", fh.read())
    assert found == [str(CHUNK)]


def test_k1_split_passes_the_chunk_to_this_trees_kernel():
    """The probe builds any tree's ``csr_segment.cu``; this tree's takes the
    fixed order's chunk length."""
    assert k1_split._takes_chunk(k1_split._CSRC)


def test_k1_split_passes_no_chunk_to_the_earlier_kernel(tmp_path):
    """The design before the fixed order took no chunk length."""
    (tmp_path / "csr_segment.cu").write_text(
        "int mgn_csr_segment_sum(const void* data, int dtype, const int* row_offsets,\n"
        "                        const int* perm, float* out, int n_rows, int f,\n"
        "                        void* stream) {\n  return 0;\n}\n")
    assert not k1_split._takes_chunk(str(tmp_path))
