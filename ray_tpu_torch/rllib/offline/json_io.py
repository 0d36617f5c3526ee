# Copied from ray_tpu/rllib/offline/json_io.py (ray_tpu -> ray_tpu_torch).
"""Offline experience IO (reference: rllib/offline/ — json_reader.py
JsonReader of SampleBatch rows and json_writer.py; SURVEY §2.4 'offline
data (offline/ 4.8k)').

Format: JSONL, one flat transition batch per line with base64-packed
float32/int64 arrays — self-describing and appendable, loadable without
RLlib."""

from __future__ import annotations

import base64
import glob as globlib
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np


def _pack(arr: np.ndarray) -> Dict:
    arr = np.asarray(arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": base64.b64encode(np.ascontiguousarray(arr)).decode()}


def _unpack(obj: Dict) -> np.ndarray:
    raw = base64.b64decode(obj["data"])
    return np.frombuffer(raw, dtype=obj["dtype"]).reshape(obj["shape"])


class JsonWriter:
    """Append transition batches to ``<path>/output-<n>.jsonl``."""

    def __init__(self, path: str, max_file_size_rows: int = 100_000):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._file_idx = 0
        self._rows_in_file = 0
        self._max_rows = max_file_size_rows
        self._fh = None

    def _ensure_file(self):
        if self._fh is None or self._rows_in_file >= self._max_rows:
            if self._fh:
                self._fh.close()
                self._file_idx += 1
                self._rows_in_file = 0
            self._fh = open(os.path.join(
                self.path, f"output-{self._file_idx:04d}.jsonl"), "a")

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self._ensure_file()
        n = len(next(iter(batch.values())))
        self._fh.write(json.dumps(
            {k: _pack(v) for k, v in batch.items()}) + "\n")
        self._fh.flush()
        self._rows_in_file += n

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class JsonReader:
    """Cycle through JSONL experience files, yielding row-batch dicts."""

    def __init__(self, inputs: str, shuffle: bool = True, seed: int = 0):
        if os.path.isdir(inputs):
            self.files = sorted(globlib.glob(os.path.join(inputs, "*.jsonl")))
        else:
            self.files = sorted(globlib.glob(inputs))
        if not self.files:
            raise FileNotFoundError(f"no offline data under {inputs!r}")
        self._rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self._batches: Optional[List[Dict[str, np.ndarray]]] = None
        self._full: Optional[Dict[str, np.ndarray]] = None
        self._cursor = 0  # sequential read position when shuffle=False

    def _load_all(self) -> List[Dict[str, np.ndarray]]:
        if self._batches is None:
            self._batches = []
            for path in self.files:
                with open(path) as f:
                    for line in f:
                        if line.strip():
                            obj = json.loads(line)
                            self._batches.append(
                                {k: _unpack(v) for k, v in obj.items()})
        return self._batches

    def concat_all(self) -> Dict[str, np.ndarray]:
        if self._full is None:  # files are immutable once read
            batches = self._load_all()
            keys = batches[0].keys()
            self._full = {k: np.concatenate([b[k] for b in batches])
                          for k in keys}
        return self._full

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        full = self.concat_all()
        n = len(next(iter(full.values())))
        if self.shuffle:
            idx = self._rng.integers(0, n, batch_size)
        else:  # cycle sequentially through the dataset
            idx = (self._cursor + np.arange(batch_size)) % n
            self._cursor = int((self._cursor + batch_size) % n)
        return {k: v[idx] for k, v in full.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        yield from self._load_all()
