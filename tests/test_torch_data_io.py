"""Port: the data readers and writers — TFRecord framing and Example
parsing against the TensorFlow-written golden fixture, a writer round trip,
and ``load_dataset``/``common_buckets`` against the JAX package on one
directory."""

import os
import struct

import numpy as np
import pytest

from mgn_tpu.data.pipeline import load_dataset as jax_load_dataset
from mgn_tpu.data.prep import common_buckets as jax_common_buckets
from mgn_tpu.data.tfrecord import parse_example as jax_parse_example
from mgn_tpu.data.tfrecord import read_records as jax_read_records
from mgn_tpu_torch.data import tfrecord as tfr
from mgn_tpu_torch.data.pipeline import load_dataset
from mgn_tpu_torch.data.prep import BytesLRU, common_buckets, prepare_trajectory
from mgn_tpu_torch.data.synthetic import write_synthetic_tfrecord_dataset
from mgn_tpu_torch.data.tfrecord_writer import example_bytes, masked_crc32c, write_tfrecord
from mgn_tpu_torch.train.common import FieldSpec

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TL = 3
GOLDEN_META = {"trajectory_length": TL, "features": {
    "cells": {"type": "static", "shape": [1, -1, 3], "dtype": "int32"},
    "mesh_pos": {"type": "static", "shape": [1, -1, 2], "dtype": "float32"},
    "node_type": {"type": "static", "shape": [1, -1, 1], "dtype": "int32"},
    "velocity": {"type": "dynamic", "shape": [TL, -1, 2], "dtype": "float32"},
}}


def test_reader_decodes_the_tensorflow_golden_fixture():
    path = os.path.join(FIX, "golden.tfrecord")
    exp = np.load(os.path.join(FIX, "golden_expected.npz"))
    assert tfr.count_records(path) == 2
    recs = list(tfr.read_records(path))
    t0 = tfr.parse_trajectory(tfr.parse_example(recs[0]), GOLDEN_META)  # raw BytesList
    for key in ("cells", "mesh_pos", "node_type"):
        np.testing.assert_array_equal(t0[key],
                                      np.broadcast_to(exp[key], (TL,) + exp[key].shape[1:]))
    np.testing.assert_array_equal(t0["velocity"], exp["velocity"])
    t1 = tfr.parse_trajectory(tfr.parse_example(recs[1]), GOLDEN_META)  # packed lists
    np.testing.assert_array_equal(t1["node_type"], np.broadcast_to(exp["node_type_neg"],
                                                                   (TL, 5, 1)))
    np.testing.assert_array_equal(t1["velocity"], exp["velocity"])
    with open(path, "rb") as f:  # our masked CRC32C reproduces TensorFlow's framing
        blob = f.read()
    pos = 0
    for payload in recs:
        header = blob[pos: pos + 8]
        assert struct.unpack("<Q", header)[0] == len(payload)
        assert struct.unpack("<I", blob[pos + 8: pos + 12])[0] == masked_crc32c(header)
        end = pos + 12 + len(payload)
        assert struct.unpack("<I", blob[end: end + 4])[0] == masked_crc32c(payload)
        pos = end + 4
    assert pos == len(blob)


def test_writer_round_trip_and_the_jax_reader_agree(tmp_path):
    rng = np.random.default_rng(3)
    feats = {"cells": rng.integers(0, 9, (1, 7, 3)).astype(np.int32),
             "mesh_pos": rng.random((1, 9, 2)).astype(np.float32),
             "node_type": rng.integers(0, 7, (1, 9, 1)).astype(np.int32),
             "velocity": rng.normal(size=(TL, 9, 2)).astype(np.float32)}
    path = str(tmp_path / "x.tfrecord")
    assert write_tfrecord(path, [example_bytes(feats)] * 2) == 2
    ours = [tfr.parse_example(p) for p in tfr.read_records(path)]
    theirs = [jax_parse_example(p) for p in jax_read_records(path)]
    assert len(ours) == len(theirs) == 2
    parsed = tfr.parse_trajectory(ours[1], GOLDEN_META)
    np.testing.assert_array_equal(parsed["velocity"], feats["velocity"])
    np.testing.assert_array_equal(parsed["cells"][0], feats["cells"][0])
    assert ours[0].keys() == theirs[0].keys()
    for k in ours[0]:
        assert ours[0][k] == theirs[0][k]


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ds"))
    write_synthetic_tfrecord_dataset(d, num_nodes=80, tl=5, n_train=3, n_valid=2, n_test=1,
                                     seed=2)
    return d


def test_load_dataset_and_common_buckets_match_jax(ds_dir):
    ours, theirs = load_dataset(ds_dir), jax_load_dataset(ds_dir)
    assert ours.meta == theirs.meta
    assert (ours.num_trajectories, ours.num_valid) == (theirs.num_trajectories,
                                                       theirs.num_valid) == (3, 2)
    for i, valid in ((0, False), (2, False), (1, True)):
        a, b = ours.trajectory(i, valid=valid), theirs.trajectory(i, valid=valid)
        for key in ("mesh_pos", "node_type", "times", "cells"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
        np.testing.assert_array_equal(a.fields["velocity"], b.fields["velocity"])
        sa, sb = ours.structure(i, valid=valid), theirs.structure(i, valid=valid)
        assert sa.num_nodes == sb.num_nodes
        np.testing.assert_array_equal(sa.cells, sb.cells)
    structs = [ours.structure(i) for i in range(3)]
    for multiples in ((128, 1024), (128, 512), (64, 256)):
        assert common_buckets(structs, ours.meta, *multiples) == \
            jax_common_buckets([theirs.structure(i) for i in range(3)], theirs.meta, *multiples)
    test = load_dataset(ds_dir, is_training=False)
    assert test.num_trajectories == 1 and test.num_valid == 0


def test_bytes_lru_evicts_to_its_cap(ds_dir):
    ds = load_dataset(ds_dir)
    spec = FieldSpec.from_meta(ds.meta)
    preps = [prepare_trajectory(ds.trajectory(i), ds.meta, spec) for i in range(3)]
    one = preps[0].nbytes
    assert one == BytesLRU.value_bytes(preps[0]) > 0
    cache = BytesLRU(2 * one + 1)
    for i in range(3):
        assert cache.get(i, lambda i=i: preps[i]) is preps[i]
    assert len(cache) == 2 and 0 not in cache and cache.total <= 2 * one + 1
    assert cache.get(1, lambda: None) is preps[1]  # a hit does not rebuild
