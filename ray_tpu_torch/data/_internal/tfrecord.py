# Copied from ray_tpu/data/_internal/tfrecord.py (ray_tpu -> ray_tpu_torch).
"""Pure-Python TFRecord + tf.train.Example codec (reference:
python/ray/data/datasource/tfrecords_datasource.py — which requires
tensorflow; here the wire formats are implemented directly so TFRecord IO
works without TF in the image).

TFRecord framing (tensorflow/core/lib/io/record_writer.cc):
  uint64 length | uint32 masked_crc32c(length) | bytes data |
  uint32 masked_crc32c(data)

tf.train.Example protobuf (feature.proto / example.proto), minimal subset:
  Example{1: Features}  Features{1: map<string, Feature>}
  Feature{1: BytesList | 2: FloatList | 3: Int64List}, each with
  repeated field 1 (floats packed little-endian f32, ints packed varint).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Union

import numpy as np

# ------------------------------------------------------------------ crc32c
_CRC_TABLE: List[int] = []


def _make_table() -> None:
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ----------------------------------------------------------- proto helpers
def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _len_delim(field: int, payload: bytes) -> bytes:
    out = bytearray()
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out.extend(payload)
    return bytes(out)


# ------------------------------------------------------------ Example enc
def _encode_feature(value) -> bytes:
    arr = np.asarray(value)
    if arr.dtype.kind in ("S", "O", "U"):
        items = arr.reshape(-1).tolist() if arr.ndim else [arr.item()]
        payload = bytearray()
        for it in items:
            if isinstance(it, str):
                it = it.encode()
            payload.extend(_len_delim(1, bytes(it)))
        return _len_delim(1, bytes(payload))  # BytesList
    if arr.dtype.kind == "f":
        data = arr.astype("<f4").tobytes()
        inner = bytearray()
        _write_varint(inner, _tag(1, 2))
        _write_varint(inner, len(data))
        inner.extend(data)
        return _len_delim(2, bytes(inner))  # FloatList (packed)
    # ints / bools
    inner = bytearray()
    packed = bytearray()
    for v in arr.reshape(-1).astype(np.int64).tolist():
        _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
    _write_varint(inner, _tag(1, 2))
    _write_varint(inner, len(packed))
    inner.extend(packed)
    return _len_delim(3, bytes(inner))  # Int64List (packed)


def encode_example(row: Dict[str, Any]) -> bytes:
    features = bytearray()
    for key, value in row.items():
        entry = (_len_delim(1, key.encode())
                 + _len_delim(2, _encode_feature(value)))
        features.extend(_len_delim(1, entry))
    return _len_delim(1, bytes(features))  # Example{1: Features}


# ------------------------------------------------------------ Example dec
def _iter_fields(buf: bytes) -> Iterator[tuple]:
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, v
        elif wire == 5:
            yield field, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield field, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_feature(buf: bytes):
    for field, payload in _iter_fields(buf):
        if field == 1:  # BytesList
            return [bytes(v) for f, v in _iter_fields(payload) if f == 1]
        if field == 2:  # FloatList
            floats: List[float] = []
            for f, v in _iter_fields(payload):
                if f == 1:
                    if isinstance(v, (bytes, memoryview)):
                        floats.extend(np.frombuffer(v, "<f4").tolist())
                    else:
                        floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, np.float32)
        if field == 3:  # Int64List
            ints: List[int] = []
            for f, v in _iter_fields(payload):
                if f == 1:
                    if isinstance(v, (bytes, memoryview)):
                        pos = 0
                        while pos < len(v):
                            x, pos = _read_varint(v, pos)
                            ints.append(x)
                    else:
                        ints.append(v)
            # two's-complement back from unsigned varint
            return np.asarray(
                [x - (1 << 64) if x >= (1 << 63) else x for x in ints],
                np.int64)
    return []


def decode_example(buf: bytes) -> Dict[str, Any]:
    row: Dict[str, Any] = {}
    for field, features in _iter_fields(buf):
        if field != 1:
            continue
        for f, entry in _iter_fields(features):
            if f != 1:
                continue
            key = None
            val = None
            for ef, ev in _iter_fields(entry):
                if ef == 1:
                    key = bytes(ev).decode()
                elif ef == 2:
                    val = _decode_feature(ev)
            if key is not None:
                row[key] = val
    return row


# --------------------------------------------------------------- file IO
def write_tfrecord_file(path: str, rows: Iterator[Dict[str, Any]]) -> int:
    n = 0
    with open(path, "wb") as f:
        for row in rows:
            data = encode_example(row)
            length = struct.pack("<Q", len(data))
            f.write(length)
            f.write(struct.pack("<I", _masked_crc(length)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
            n += 1
    return n


def read_tfrecord_file(path: str) -> Iterator[Dict[str, Any]]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(
                    f"truncated TFRecord header in {path}: "
                    f"{len(header)} of 12 bytes")
            (length,) = struct.unpack("<Q", header[:8])
            (crc,) = struct.unpack("<I", header[8:12])
            if _masked_crc(header[:8]) != crc:
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(
                    f"truncated TFRecord in {path}: record declares "
                    f"{length} bytes, file had {len(data)}")
            f.read(4)  # data crc (skipped on read, like TF's default)
            yield decode_example(data)
