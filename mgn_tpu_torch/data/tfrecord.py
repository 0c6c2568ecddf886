"""Pure-Python TFRecord + tf.train.Example reader (no TensorFlow import): the
port's copy of ``mgn_tpu/data/tfrecord.py``.

DeepMind MeshGraphNets datasets store one trajectory per Example;
every feature is a single bytes entry holding a raw little-endian array that is
reinterpreted by the meta.json dtype and reshaped by the meta ``shape`` (one
``-1`` dim inferred); static features are broadcast across the trajectory.

The record framing and the protobuf wire format are decoded by hand (~100
lines) so the data path has no TensorFlow dependency and imports in
milliseconds.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["read_records", "parse_example", "parse_trajectory", "count_records"]

_DTYPES = {
    "float32": np.dtype("<f4"),
    "float64": np.dtype("<f8"),
    "int32": np.dtype("<i4"),
    "int64": np.dtype("<i8"),
    "bool": np.dtype("bool"),
}


def read_records(path: str) -> Iterator[bytes]:
    """Iterate raw record payloads of a TFRecord file.

    Framing: u64 length | u32 masked-crc(length) | payload | u32 masked-crc(payload).
    CRCs are not verified (we are not defending against disk corruption here).
    """
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            if len(payload) < length:
                raise EOFError(f"truncated TFRecord in {path}")
            f.read(4)  # payload crc
            yield payload


def count_records(path: str) -> int:
    n = 0
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return n
            (length,) = struct.unpack("<Q", header[:8])
            f.seek(length + 4, os.SEEK_CUR)
            n += 1


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) for a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes) -> Any:
    """tf.train.Feature -> bytes | np.ndarray.

    Accepts both legal wire encodings of the repeated scalar lists — packed
    (possibly split across several length-delimited chunks) and unpacked
    (one tag per element) — and wraps int64 varints to two's complement
    (negative values arrive as 10-byte varints >= 2**63; pinned by the
    TensorFlow-written golden fixture, tests/fixtures/golden.tfrecord).
    """
    for field, _, val in _iter_fields(buf):
        if field == 1:  # BytesList
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    return v2
        elif field == 2:  # FloatList
            chunks = [v2 for f2, _, v2 in _iter_fields(val) if f2 == 1]
            return np.frombuffer(b"".join(chunks), dtype="<f4")
        elif field == 3:  # Int64List
            out: List[int] = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 != 1:
                    continue
                vals = [v2] if w2 == 0 else []
                if w2 == 2:  # packed chunk of varints
                    pos = 0
                    while pos < len(v2):
                        x, pos = _read_varint(v2, pos)
                        vals.append(x)
                out.extend(x - (1 << 64) if x >= (1 << 63) else x
                           for x in vals)
            return np.asarray(out, np.int64)
    return b""


def parse_example(payload: bytes, keys=None) -> Dict[str, Any]:
    """tf.train.Example payload -> {feature_name: bytes | ndarray}.

    ``keys``: optional set of feature names to decode — other features are
    skipped without copying their payload bytes (cheap structure probes over
    every record, e.g. bucket sizing)."""
    out: Dict[str, Any] = {}
    for field, _, val in _iter_fields(payload):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:  # Features.feature map entry
                continue
            key = None
            raw = None
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    raw = v3
            if key is not None and (keys is None or key in keys):
                out[key] = _parse_feature(raw) if raw is not None else b""
    return out


def parse_trajectory(example: Dict[str, Any], meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Decode one Example into {feature: (T, N, dim)} arrays.

    Row-major layout: raw bytes -> dtype array -> reshape by meta ``shape``
    with one inferred ``-1`` dim -> static features broadcast to T frames.
    """
    tl = int(meta["trajectory_length"])
    out: Dict[str, np.ndarray] = {}
    for key, fmeta in meta["features"].items():
        if key not in example:
            continue
        raw = example[key]
        dtype = _DTYPES[fmeta.get("dtype", "float32")]
        if isinstance(raw, bytes):
            d = np.frombuffer(raw, dtype=dtype)
        else:
            d = np.asarray(raw).astype(dtype)
        shape = list(fmeta["shape"])
        if -1 in shape:
            known = -int(np.prod([s for s in shape]))  # product including the -1
            shape[shape.index(-1)] = d.size // max(known, 1)
        d = d.reshape(shape)
        if fmeta.get("type", "static") == "static" and d.shape[0] == 1:
            d = np.broadcast_to(d, (tl,) + d.shape[1:])
        out[key] = d
    return out
