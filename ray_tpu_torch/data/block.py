# Copied from ray_tpu/data/block.py (ray_tpu -> ray_tpu_torch).
"""Block format for ray_tpu_torch.data.

A block is the unit of parallelism: one contiguous shard of a Dataset that
flows between operators as an ``ObjectRef``. The reference standardizes on
Arrow tables in plasma (reference: python/ray/data/block.py,
``_internal/arrow_block.py``); we do the same but additionally allow a
"tensor block" — a dict of numpy arrays — as a first-class representation,
because feeding a card wants contiguous ndarrays that a host-to-device copy
can ship without a columnar decode step.

``BlockAccessor`` dispatches over the two representations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover - pyarrow is in the image
    pa = None

# Block = pyarrow.Table | Dict[str, np.ndarray]
Block = Union["pa.Table", Dict[str, np.ndarray]]


@dataclasses.dataclass
class BlockMetadata:
    """Sidecar stats shipped with every block ref so the executor can
    schedule and account without fetching payloads (reference:
    python/ray/data/block.py BlockMetadata)."""

    num_rows: int
    size_bytes: int
    schema: Optional[Dict[str, str]] = None
    input_files: Optional[List[str]] = None
    exec_time_s: float = 0.0


class BlockAccessor:
    """Uniform view over the two block representations."""

    def __init__(self, block: Block):
        self._block = block
        self._is_arrow = pa is not None and isinstance(block, pa.Table)

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # ------------------------------------------------------------- building
    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Normalize a UDF's output batch into a block."""
        if pa is not None and isinstance(batch, pa.Table):
            return batch
        if isinstance(batch, dict):
            out: Dict[str, np.ndarray] = {}
            multidim = False
            for k, v in batch.items():
                arr = np.asarray(v)
                out[k] = arr
                if arr.ndim > 1 or arr.dtype == object:
                    multidim = True
            if not out:
                return {}
            n = {len(a) for a in out.values()}
            if len(n) > 1:
                raise ValueError(
                    f"batch columns have mismatched lengths: "
                    f"{ {k: len(v) for k, v in out.items()} }")
            if multidim or pa is None:
                return out
            return pa.table(out)
        try:
            import pandas as pd

            if isinstance(batch, pd.DataFrame):
                return pa.Table.from_pandas(batch, preserve_index=False)
        except ImportError:  # pragma: no cover
            pass
        if isinstance(batch, list):
            return BlockAccessor.rows_to_block(batch)
        if isinstance(batch, np.ndarray):
            return BlockAccessor.batch_to_block({"data": batch})
        raise TypeError(
            f"cannot convert batch of type {type(batch).__name__} to a block "
            "(expected dict of arrays, pyarrow.Table, pandas.DataFrame, "
            "list of rows, or ndarray)")

    @staticmethod
    def rows_to_block(rows: List[Any]) -> Block:
        if not rows:
            return pa.table({}) if pa is not None else {}
        if not isinstance(rows[0], dict):
            rows = [{"item": r} for r in rows]
        cols: Dict[str, list] = {k: [] for k in rows[0]}
        uniform = True
        for r in rows:
            if set(r) != set(cols):
                uniform = False
                break
        if not uniform:
            keys = []
            for r in rows:
                for k in r:
                    if k not in keys:
                        keys.append(k)
            cols = {k: [r.get(k) for r in rows] for k in keys}
        else:
            for r in rows:
                for k, v in r.items():
                    cols[k].append(v)
        # ndarray-valued fields → tensor block
        if any(isinstance(v[0], np.ndarray) for v in cols.values() if len(v)):
            return {k: np.stack(v) if isinstance(v[0], np.ndarray)
                    else np.asarray(v) for k, v in cols.items()}
        if pa is None:  # pragma: no cover
            return {k: np.asarray(v) for k, v in cols.items()}
        try:
            return pa.table(cols)
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
            return {k: np.asarray(v, dtype=object) for k, v in cols.items()}

    # ------------------------------------------------------------- reading
    def num_rows(self) -> int:
        if self._is_arrow:
            return self._block.num_rows
        if not self._block:
            return 0
        return len(next(iter(self._block.values())))

    def size_bytes(self) -> int:
        if self._is_arrow:
            return self._block.nbytes
        return int(sum(a.nbytes if a.dtype != object else len(a) * 64
                       for a in self._block.values()))

    def schema(self) -> Optional[Dict[str, str]]:
        if self._is_arrow:
            return {f.name: str(f.type) for f in self._block.schema}
        return {k: f"{v.dtype}{list(v.shape[1:]) if v.ndim > 1 else ''}"
                for k, v in self._block.items()}

    def column_names(self) -> List[str]:
        if self._is_arrow:
            return self._block.column_names
        return list(self._block.keys())

    def metadata(self, **kw) -> BlockMetadata:
        return BlockMetadata(num_rows=self.num_rows(),
                             size_bytes=self.size_bytes(),
                             schema=self.schema(), **kw)

    # --------------------------------------------------------- conversions
    def to_arrow(self) -> "pa.Table":
        if self._is_arrow:
            return self._block
        return pa.table({k: v.tolist() if v.ndim > 1 else v
                         for k, v in self._block.items()})

    def to_pandas(self):
        import pandas as pd

        if self._is_arrow:
            return self._block.to_pandas()
        return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                             for k, v in self._block.items()})

    def to_numpy_dict(self) -> Dict[str, np.ndarray]:
        if not self._is_arrow:
            return dict(self._block)
        out = {}
        for name in self._block.column_names:
            col = self._block.column(name)
            try:
                out[name] = col.to_numpy(zero_copy_only=False)
            except (pa.ArrowInvalid, NotImplementedError):
                out[name] = np.asarray(col.to_pylist(), dtype=object)
        return out

    def to_batch(self, batch_format: str = "numpy") -> Any:
        if batch_format in ("numpy", "default"):
            return self.to_numpy_dict()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        if self._is_arrow:
            for batch in self._block.to_batches():
                yield from batch.to_pylist()
        else:
            keys = list(self._block)
            for i in range(self.num_rows()):
                yield {k: self._block[k][i] for k in keys}

    # ------------------------------------------------------------ slicing
    def slice(self, start: int, end: int) -> Block:
        if self._is_arrow:
            return self._block.slice(start, end - start)
        return {k: v[start:end] for k, v in self._block.items()}

    def take_indices(self, idx: np.ndarray) -> Block:
        if self._is_arrow:
            return self._block.take(pa.array(idx))
        return {k: v[idx] for k, v in self._block.items()}

    def select(self, columns: List[str]) -> Block:
        if self._is_arrow:
            return self._block.select(columns)
        return {k: self._block[k] for k in columns}

    def drop(self, columns: List[str]) -> Block:
        keep = [c for c in self.column_names() if c not in columns]
        return self.select(keep)

    def rename(self, mapping: Dict[str, str]) -> Block:
        if self._is_arrow:
            return self._block.rename_columns(
                [mapping.get(c, c) for c in self._block.column_names])
        return {mapping.get(k, k): v for k, v in self._block.items()}

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        nonempty = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not nonempty:
            # keep schema from the first (empty) block if there is one
            return blocks[0] if blocks else (
                pa.table({}) if pa is not None else {})
        blocks = nonempty
        if len(blocks) == 1:
            return blocks[0]
        if all(pa is not None and isinstance(b, pa.Table) for b in blocks):
            return pa.concat_tables(blocks, promote_options="default")
        dicts = [BlockAccessor(b).to_numpy_dict() for b in blocks]
        keys = list(dicts[0])
        return {k: np.concatenate([d[k] for d in dicts]) for k in keys}

    def sort_indices(self, key: Union[str, List[str]],
                     descending: bool = False) -> np.ndarray:
        keys = [key] if isinstance(key, str) else list(key)
        nd = self.to_numpy_dict()
        arrs = [nd[k] for k in reversed(keys)]
        idx = np.lexsort(arrs)
        return idx[::-1] if descending else idx

