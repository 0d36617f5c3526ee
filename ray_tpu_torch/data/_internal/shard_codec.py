# Copied from ray_tpu/data/_internal/shard_codec.py (ray_tpu -> ray_tpu_torch).
"""Packed-shard codec: one Block <-> ONE contiguous uint8 ndarray.

The streaming shuffle ships every map-output shard as a bare
contiguous array so the store serializes it on the ``ZeroCopyArray`` typed
fast path (``_private/serialization.py``): a single memcpy into the shm
segment on the producing node, and on the pulling node the reducer decodes
COLUMN VIEWS aliasing the store mmap — no pickle pass in either direction
and no intermediate copies of multi-MB shard payloads.

Wire layout (little-endian, payloads 64-byte aligned so decoded views
satisfy any dtype's alignment):

    [u32 magic 'RTSB'][u8 version][u32 header_len][header pickle]
    [pad to 64][col 0 payload][pad to 64][col 1 payload]...

The header is a plain-pickle list of column descriptors
``(name, kind, dtype_tag, shape, nbytes)``; payload offsets are NOT
stored — encoder and decoder walk the same deterministic
align-and-advance sequence. ``kind`` is ``"nd"`` for numeric columns
stored raw, or ``"pkl"`` for object-dtype / untaggable-dtype columns
stored as a pickle blob (strings survive, they just do not get the
zero-copy view). This module must stay importable without torch
(shuffle workers never touch the device runtime).
"""

from __future__ import annotations

import pickle
import struct
from typing import Dict, List, Tuple

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch._private.serialization import _dtype_tag, _resolve_dtype

_MAGIC = 0x52545342  # 'RTSB'
_VERSION = 1
_ALIGN = 64
_PREFIX = "<IBI"  # magic, version, header_len
_PREFIX_LEN = struct.calcsize(_PREFIX)


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def encode_shard(block: Block) -> np.ndarray:
    """Pack ``block`` into one contiguous uint8 array (see module doc)."""
    nd = BlockAccessor(block).to_numpy_dict()
    cols: List[Tuple[str, str, str, tuple, int]] = []
    payloads: List[np.ndarray] = []
    for name, arr in nd.items():
        tag = None if arr.dtype.hasobject else _dtype_tag(arr.dtype)
        if tag is None:
            raw = np.frombuffer(
                pickle.dumps(arr, protocol=5), dtype=np.uint8)
            cols.append((name, "pkl", "", (), raw.nbytes))
        else:
            a = np.ascontiguousarray(arr)
            raw = (a.reshape(-1).view(np.uint8) if a.nbytes
                   else np.empty(0, np.uint8))
            cols.append((name, "nd", tag, a.shape, a.nbytes))
        payloads.append(raw)
    header = pickle.dumps(cols, protocol=4)
    off = _align(_PREFIX_LEN + len(header))
    total = off
    for raw in payloads:
        total = _align(total) + raw.nbytes
    out = np.zeros(max(total, off), dtype=np.uint8)
    struct.pack_into(_PREFIX, out, 0, _MAGIC, _VERSION, len(header))
    out[_PREFIX_LEN:_PREFIX_LEN + len(header)] = np.frombuffer(
        header, dtype=np.uint8)
    for raw in payloads:
        off = _align(off)
        out[off:off + raw.nbytes] = raw
        off += raw.nbytes
    return out


def is_packed_shard(arr) -> bool:
    if not isinstance(arr, np.ndarray) or arr.dtype != np.uint8 \
            or arr.ndim != 1 or arr.nbytes < _PREFIX_LEN:
        return False
    magic, version, _ = struct.unpack_from(_PREFIX, arr)
    return magic == _MAGIC and version == _VERSION


def decode_shard(arr: np.ndarray) -> Dict[str, np.ndarray]:
    """Unpack a packed shard into a tensor block (dict of columns).

    Numeric columns come back as VIEWS into ``arr`` — when ``arr`` is a
    zero-copy get() result they alias the store mmap directly (read-only,
    which is fine: every consumer copies on concat/permute). Object
    columns are unpickled.
    """
    if not is_packed_shard(arr):
        raise ValueError("not a packed shard (bad magic/version)")
    _, _, header_len = struct.unpack_from(_PREFIX, arr)
    cols = pickle.loads(
        arr[_PREFIX_LEN:_PREFIX_LEN + header_len].tobytes())
    out: Dict[str, np.ndarray] = {}
    off = _align(_PREFIX_LEN + header_len)
    for name, kind, tag, shape, nbytes in cols:
        off = _align(off)
        payload = arr[off:off + nbytes]
        off += nbytes
        if kind == "pkl":
            out[name] = pickle.loads(payload.tobytes())
        else:
            out[name] = payload.view(_resolve_dtype(tag)).reshape(shape)
    return out
