"""Pure-Python TFRecord + tf.train.Example writer (no TensorFlow import).

The port's copy of ``mgn_tpu/data/tfrecord_writer.py``, counterpart of
:mod:`mgn_tpu_torch.data.tfrecord`: writes DeepMind-MeshGraphNets-schema
datasets (one trajectory per Example, each feature a single BytesList entry
holding the raw little-endian tensor, meta.json ``shape``/``dtype``
describing the layout).  Records carry real masked-CRC32C framing so the
files are valid for strict readers (TensorFlow's included).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterable, Sequence

import numpy as np

__all__ = ["write_tfrecord", "example_bytes", "write_tfrecord_dataset",
           "masked_crc32c"]

# --- CRC32C (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15 and add a constant."""
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- protobuf wire encoding ---------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _field(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def example_bytes(features: Dict[str, np.ndarray]) -> bytes:
    """Encode a tf.train.Example whose features are raw-bytes tensors."""
    entries = b""
    for key, arr in features.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        bytes_list = _field(1, arr.tobytes())  # BytesList.value
        feature = _field(1, bytes_list)  # Feature.bytes_list
        entry = _field(1, key.encode("utf-8")) + _field(2, feature)
        entries += _field(1, entry)  # Features.feature map entry
    return _field(1, entries)  # Example.features


def write_tfrecord(path: str, examples: Iterable[bytes]) -> int:
    """Write framed records: u64 len | crc(len) | payload | crc(payload)."""
    n = 0
    with open(path, "wb") as f:
        for payload in examples:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))
            n += 1
    return n


def write_tfrecord_dataset(
    dst: str,
    meta: Dict[str, Any],
    splits: Dict[str, Sequence[Dict[str, np.ndarray]]],
) -> None:
    """Write ``<dst>/meta.json`` + one ``<split>.tfrecord`` per split.

    ``splits`` maps split name -> list of per-trajectory feature dicts whose
    arrays already match the meta ``shape`` convention ((1, N, dim) static,
    (T, N, dim) dynamic).
    """
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    for split, trajs in splits.items():
        dtypes = {k: np.dtype(meta["features"][k].get("dtype", "float32"))
                  for k in meta["features"]}
        write_tfrecord(
            os.path.join(dst, f"{split}.tfrecord"),
            (example_bytes({k: np.asarray(v, dtypes.get(k))
                            for k, v in traj.items()}) for traj in trajs),
        )
