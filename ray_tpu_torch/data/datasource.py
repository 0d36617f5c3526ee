# Copied from ray_tpu/data/datasource.py (ray_tpu -> ray_tpu_torch).
"""Datasources: each produces a list of read tasks (closures returning
blocks), one per file/fragment, so reads parallelize as tasks
(reference: python/ray/data/datasource/ + read_api.py).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            pat = os.path.join(p, "**", f"*{suffix}" if suffix else "*")
            out.extend(sorted(f for f in glob.glob(pat, recursive=True)
                              if os.path.isfile(f)))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


class Datasource:
    """ABC (reference: datasource/datasource.py Datasource/Reader)."""

    name = "Datasource"

    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Any]]:
        raise NotImplementedError


class RangeDatasource(Datasource):
    name = "Range"

    def __init__(self, n: int, tensor_shape: Optional[tuple] = None,
                 column: str = "id"):
        self.n = n
        self.tensor_shape = tensor_shape
        self.column = column

    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Any]]:
        parallelism = max(1, min(parallelism, self.n or 1))
        tasks = []
        per = (self.n + parallelism - 1) // parallelism if self.n else 0
        for i in range(parallelism):
            lo, hi = i * per, min((i + 1) * per, self.n)
            if lo >= hi and self.n > 0:
                continue
            shape, col = self.tensor_shape, self.column

            def read(lo=lo, hi=hi):
                ids = np.arange(lo, hi, dtype=np.int64)
                if shape is None:
                    return {col: ids}
                data = np.broadcast_to(
                    ids.reshape((-1,) + (1,) * len(shape)),
                    (hi - lo,) + shape).astype(np.float64)
                return {col: np.ascontiguousarray(data)}

            tasks.append(read)
        return tasks or [lambda: {self.column: np.asarray([], np.int64)}]


class ItemsDatasource(Datasource):
    name = "FromItems"

    def __init__(self, items: List[Any]):
        self.items = items

    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Any]]:
        from ray_tpu_torch.data.block import BlockAccessor

        n = len(self.items)
        parallelism = max(1, min(parallelism, n or 1))
        per = (n + parallelism - 1) // parallelism if n else 0
        tasks = []
        for i in range(parallelism):
            chunk = self.items[i * per:(i + 1) * per]
            if not chunk and n > 0:
                continue
            tasks.append(lambda chunk=chunk: BlockAccessor.rows_to_block(chunk))
        return tasks or [lambda: BlockAccessor.rows_to_block([])]


class FileDatasource(Datasource):
    """One read task per file."""

    suffix: Optional[str] = None

    def __init__(self, paths, **read_kwargs):
        self.paths = _expand_paths(paths, self.suffix)
        self.read_kwargs = read_kwargs

    def read_file(self, path: str) -> Any:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Any]]:
        return [lambda p=p: self.read_file(p) for p in self.paths]


class ParquetDatasource(FileDatasource):
    name = "ReadParquet"
    suffix = ".parquet"

    def read_file(self, path: str):
        import pyarrow.parquet as pq

        return pq.read_table(path, **self.read_kwargs)


class CSVDatasource(FileDatasource):
    name = "ReadCSV"
    suffix = ".csv"

    def read_file(self, path: str):
        import pyarrow.csv as pacsv

        return pacsv.read_csv(path, **self.read_kwargs)


class JSONDatasource(FileDatasource):
    name = "ReadJSON"
    suffix = ".json"

    def read_file(self, path: str):
        import pyarrow.json as pajson

        return pajson.read_json(path, **self.read_kwargs)


class TextDatasource(FileDatasource):
    name = "ReadText"
    suffix = None

    def read_file(self, path: str):
        with open(path, "r", errors="replace") as f:
            lines = [ln.rstrip("\n") for ln in f]
        return {"text": np.asarray(lines, dtype=object)}


class BinaryDatasource(FileDatasource):
    name = "ReadBinary"
    suffix = None

    def read_file(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        return {"bytes": np.asarray([data], dtype=object),
                "path": np.asarray([path], dtype=object)}


class NumpyDatasource(FileDatasource):
    name = "ReadNumpy"
    suffix = ".npy"

    def read_file(self, path: str):
        return {"data": np.load(path)}


class TFRecordDatasource(FileDatasource):
    """tf.train.Example TFRecords via the built-in pure-Python codec
    (reference: data/datasource/tfrecords_datasource.py, minus the
    tensorflow dependency)."""

    name = "ReadTFRecords"
    suffix = ".tfrecord"

    def read_file(self, path: str):
        from ray_tpu_torch.data._internal.tfrecord import read_tfrecord_file
        from ray_tpu_torch.data.block import BlockAccessor

        rows = []
        for row in read_tfrecord_file(path):
            flat = {}
            for k, v in row.items():
                if isinstance(v, list):  # BytesList
                    flat[k] = v[0] if len(v) == 1 else v
                elif isinstance(v, np.ndarray) and v.size == 1:
                    flat[k] = v[0]
                else:
                    flat[k] = v
            rows.append(flat)
        return BlockAccessor.rows_to_block(rows)


class WebDatasetDatasource(FileDatasource):
    """WebDataset tar shards (reference: data/datasource/
    webdataset_datasource.py): samples are groups of tar members sharing
    a basename — ``0001.jpg`` + ``0001.cls`` -> one row with columns
    ``jpg``, ``cls`` (+ ``__key__``). Decoding: .json -> object,
    common image suffixes -> HWC uint8 via PIL, text suffixes -> str,
    everything else raw bytes."""

    name = "ReadWebDataset"
    suffix = ".tar"

    IMAGE_EXTS = ("jpg", "jpeg", "png", "bmp", "webp")
    TEXT_EXTS = ("txt", "cls", "text")

    def _decode(self, ext: str, data: bytes):
        import io
        import json as _json

        if ext == "json":
            return _json.loads(data)
        if ext in self.IMAGE_EXTS:
            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        if ext in self.TEXT_EXTS:
            return data.decode()
        return data

    def read_file(self, path: str):
        import tarfile

        from ray_tpu_torch.data.block import BlockAccessor

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                base, _, ext = member.name.rpartition(".")
                if not base:
                    base, ext = member.name, ""
                if base not in samples:
                    samples[base] = {"__key__": base}
                    order.append(base)
                data = tf.extractfile(member).read()
                samples[base][ext.lower()] = self._decode(ext.lower(),
                                                          data)
        return BlockAccessor.rows_to_block(
            [samples[k] for k in order])


class ImageDatasource(FileDatasource):
    """Image files via PIL (reference: data/datasource/
    image_datasource.py): columns ``image`` (HWC uint8) + ``path``."""

    name = "ReadImages"
    suffix = None

    IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

    def __init__(self, paths, size=None, mode: str = "RGB", **kw):
        super().__init__(paths, **kw)
        self.paths = [p for p in self.paths
                      if p.lower().endswith(self.IMAGE_EXTS)]
        if not self.paths:
            raise FileNotFoundError(f"no image files in {paths!r}")
        self.size = size
        self.mode = mode

    def read_file(self, path: str):
        from PIL import Image

        img = Image.open(path)
        if self.mode:
            img = img.convert(self.mode)
        if self.size:
            img = img.resize((self.size[1], self.size[0]))
        arr = np.asarray(img)
        return {"image": arr[None], "path": np.asarray([path], object)}


# ------------------------------------------------------------------ writers
def write_parquet_fn(path: str):
    os.makedirs(path, exist_ok=True)

    def write(batch):
        import uuid

        import pyarrow.parquet as pq

        from ray_tpu_torch.data.block import BlockAccessor

        table = BlockAccessor(BlockAccessor.batch_to_block(batch)).to_arrow()
        fn = os.path.join(path, f"part-{uuid.uuid4().hex[:12]}.parquet")
        pq.write_table(table, fn)
        return {"path": np.asarray([fn], dtype=object),
                "num_rows": np.asarray([table.num_rows])}

    return write


def write_tfrecords_fn(path: str):
    os.makedirs(path, exist_ok=True)

    def write(batch):
        import uuid

        from ray_tpu_torch.data._internal.tfrecord import write_tfrecord_file
        from ray_tpu_torch.data.block import BlockAccessor

        acc = BlockAccessor(BlockAccessor.batch_to_block(batch))
        fn = os.path.join(path, f"part-{uuid.uuid4().hex[:12]}.tfrecord")
        n = write_tfrecord_file(fn, acc.iter_rows())
        return {"path": np.asarray([fn], dtype=object),
                "num_rows": np.asarray([n])}

    return write


def write_csv_fn(path: str):
    os.makedirs(path, exist_ok=True)

    def write(batch):
        import uuid

        import pyarrow.csv as pacsv

        from ray_tpu_torch.data.block import BlockAccessor

        table = BlockAccessor(BlockAccessor.batch_to_block(batch)).to_arrow()
        fn = os.path.join(path, f"part-{uuid.uuid4().hex[:12]}.csv")
        pacsv.write_csv(table, fn)
        return {"path": np.asarray([fn], dtype=object),
                "num_rows": np.asarray([table.num_rows])}

    return write


def write_json_fn(path: str):
    os.makedirs(path, exist_ok=True)

    def write(batch):
        import json
        import uuid

        from ray_tpu_torch.data.block import BlockAccessor

        acc = BlockAccessor(BlockAccessor.batch_to_block(batch))
        fn = os.path.join(path, f"part-{uuid.uuid4().hex[:12]}.json")
        with open(fn, "w") as f:
            for row in acc.iter_rows():
                f.write(json.dumps(
                    {k: (v.tolist() if isinstance(v, np.ndarray)
                         else v.item() if isinstance(v, np.generic) else v)
                     for k, v in row.items()}) + "\n")
        return {"path": np.asarray([fn], dtype=object),
                "num_rows": np.asarray([acc.num_rows()])}

    return write


class SQLDatasource(Datasource):
    """DBAPI2 reads (reference: read_api.py:1902 read_sql — connection
    factory + query; parallelized by wrapping the query in LIMIT/OFFSET
    windows when a row count is obtainable, else a single task)."""

    name = "SQL"

    def __init__(self, sql: str, connection_factory):
        self.sql = sql.strip().rstrip(";")
        self.connection_factory = connection_factory

    def _count(self) -> Optional[int]:
        try:
            conn = self.connection_factory()
            try:
                cur = conn.cursor()
                cur.execute(f"SELECT COUNT(*) FROM ({self.sql}) AS _q")
                return int(cur.fetchone()[0])
            finally:
                conn.close()
        except Exception:
            return None

    def get_read_tasks(self, parallelism: int):
        import pyarrow as pa

        sql = self.sql
        factory = self.connection_factory

        def fetch(query: str):
            conn = factory()
            try:
                cur = conn.cursor()  # DBAPI2: execute lives on the cursor
                cur.execute(query)
                cols = [d[0] for d in cur.description]
                rows = cur.fetchall()
            finally:
                conn.close()
            data = {c: [r[i] for r in rows] for i, c in enumerate(cols)}
            return pa.table(data)

        # LIMIT/OFFSET windows are only consistent when the scan order is
        # stable: without ORDER BY, engines may return rows in a different
        # order per execution and windows can overlap or drop rows
        lowered = sql.lower()
        if "order by" not in lowered or " limit " in f" {lowered} ":
            if parallelism > 1:
                import logging

                logging.getLogger("ray_tpu_torch.data").info(
                    "read_sql: query has no ORDER BY; reading as one task "
                    "(windowed parallelism needs a stable order)")
            return [lambda: fetch(sql)]
        total = self._count()
        if not total or parallelism <= 1:
            return [lambda: fetch(sql)]
        parallelism = min(parallelism, total)
        chunk = -(-total // parallelism)
        tasks = []
        for i in range(parallelism):
            off = i * chunk
            if off >= total:
                break
            # append directly: a subquery's ORDER BY need not propagate to
            # the outer SELECT, which would defeat the stable-window premise
            q = f"{sql} LIMIT {chunk} OFFSET {off}"
            tasks.append(lambda q=q: fetch(q))
        return tasks


def _docs_to_block(docs: List[Dict]) -> Dict[str, List]:
    """Column-union a list of documents (a field first appearing
    mid-collection must not silently vanish)."""
    for d in docs:
        d.pop("_id", None)
    if not docs:
        return {"_empty": []}
    keys: List[str] = []
    for d in docs:
        for k in d:
            if k not in keys:
                keys.append(k)
    return {k: [d.get(k) for d in docs] for k in keys}


def _mongo_range_filters(split_points: List, lo, hi) -> List[Dict]:
    """[lo, p1), [p1, p2), ..., [pN, hi] range filters over _id
    (reference: mongo_datasource.py splits the collection by _id
    boundaries so each read task scans a disjoint slice)."""
    bounds = [lo] + list(split_points) + [hi]
    filters = []
    for i in range(len(bounds) - 1):
        f: Dict = {"_id": {"$gte": bounds[i]}}
        if i < len(bounds) - 2:
            f["_id"]["$lt"] = bounds[i + 1]
        else:
            f["_id"]["$lte"] = bounds[i + 1]
        filters.append(f)
    return filters


class MongoDatasource(Datasource):
    """MongoDB reads partitioned by _id ranges (reference:
    python/ray/data/datasource/mongo_datasource.py — each read task
    scans a disjoint _id slice so ``parallelism`` is honored).
    ``pymongo`` is not in this deployment's package set: construction
    composes offline and read tasks raise a clear ImportError at
    execution; ``_collection_factory`` injects a client for tests (the
    partitioned path executes against a fake collection)."""

    name = "Mongo"

    def __init__(self, uri: str, database: str, collection: str,
                 pipeline: Optional[List[Dict]] = None,
                 _collection_factory=None):
        self.uri = uri
        self.database = database
        self.collection = collection
        self.pipeline = pipeline or []
        self._collection_factory = _collection_factory

    def _collection(self):
        if self._collection_factory is not None:
            return self._collection_factory()
        try:
            import pymongo
        except ImportError as e:
            raise ImportError(
                "read_mongo requires `pymongo`, which is not installed "
                "in this environment") from e
        client = pymongo.MongoClient(self.uri)
        return client[self.database][self.collection]

    def _split_bounds(self, parallelism: int):
        """(lo, hi, interior split points) via $bucketAuto server-side
        sampling; (None, None, []) => unsplittable (empty/tiny/gated)."""
        try:
            coll = self._collection()
            buckets = list(coll.aggregate([
                {"$bucketAuto": {"groupBy": "$_id",
                                 "buckets": max(1, parallelism)}}]))
        except ImportError:
            raise
        except Exception:
            return None, None, []
        if not buckets:
            return None, None, []
        lo = buckets[0]["_id"]["min"]
        hi = buckets[-1]["_id"]["max"]
        points = [b["_id"]["min"] for b in buckets[1:]]
        return lo, hi, points

    def get_read_tasks(self, parallelism: int):
        src = self
        pipeline = self.pipeline

        def read_range(flt: Optional[Dict]):
            coll = src._collection()
            if pipeline:
                docs = list(coll.aggregate(pipeline))
            else:
                docs = list(coll.find(flt or {}))
            return _docs_to_block(docs)

        if parallelism <= 1 or pipeline:
            # a user aggregation pipeline ($group/$sort/$limit) computes a
            # GLOBAL answer: sharding it by _id slices would return per-
            # partition partials — run it as one whole-collection task
            return [lambda: read_range(None)]
        try:
            lo, hi, points = self._split_bounds(parallelism)
        except ImportError as e:
            # gated: keep the task-shape contract (N tasks) so pipelines
            # compose; each raises the clear ImportError at execution.
            # The closures must RAISE, not fall back to whole-collection
            # reads — if workers' runtime_env has pymongo while the driver
            # doesn't, N whole-collection closures would duplicate every
            # document N times.
            msg = (f"MongoDatasource requires pymongo on the driver to "
                   f"partition reads: {e}")

            def gated() -> None:
                raise ImportError(msg)

            return [gated for _ in range(parallelism)]
        if lo is None or not points:
            return [lambda: read_range(None)]
        filters = _mongo_range_filters(points, lo, hi)
        return [lambda f=f: read_range(f) for f in filters]


class BigQueryDatasource(Datasource):
    """BigQuery reads partitioned by Storage-API read streams
    (reference: python/ray/data/datasource/bigquery_datasource.py —
    create_read_session(max_stream_count=parallelism), one task per
    stream). Gated like Mongo: composes offline, raises a clear
    ImportError at read time; ``_client_factory`` injects a fake
    storage client so the stream-split path executes in tests."""

    name = "BigQuery"

    def __init__(self, project_id: str, query: Optional[str] = None,
                 dataset: Optional[str] = None, _client_factory=None):
        if not (query or dataset):
            raise ValueError("BigQueryDatasource needs query= or dataset=")
        self.project_id = project_id
        self.query = query
        self.dataset = dataset
        self._client_factory = _client_factory

    def _storage_client(self):
        if self._client_factory is not None:
            return self._client_factory()
        try:
            from google.cloud import bigquery_storage
        except ImportError as e:
            raise ImportError(
                "read_bigquery requires `google-cloud-bigquery[-storage]`"
                ", which is not installed in this environment") from e
        return bigquery_storage.BigQueryReadClient()

    def get_read_tasks(self, parallelism: int):
        src = self

        def read_query():
            # query path: BQ materializes the result; stream-splitting
            # applies to table reads below
            try:
                from google.cloud import bigquery
            except ImportError as e:
                raise ImportError(
                    "read_bigquery requires `google-cloud-bigquery`, "
                    "which is not installed in this environment") from e
            client = bigquery.Client(project=src.project_id)
            return client.query(src.query).to_arrow()

        if self.query:
            return [read_query]

        def read_stream(stream_name: str):
            # client built INSIDE the task: read tasks ship to workers by
            # pickle and a live gRPC client cannot ride the closure
            client = src._storage_client()
            rows = client.read_rows(stream_name)
            if hasattr(rows, "pages"):
                import pyarrow as pa  # bigquery ships arrow batches

                return pa.Table.from_batches(
                    [page.to_arrow() for page in rows.pages])
            return rows.to_arrow()

        # table path: one read task per storage stream
        parts = self.dataset.split(".")
        if len(parts) != 2:
            raise ValueError(
                f"dataset must be '<dataset>.<table>', got {self.dataset!r}")
        table = (f"projects/{self.project_id}/datasets/{parts[0]}"
                 f"/tables/{parts[1]}")
        try:
            client = self._storage_client()
            session = client.create_read_session(
                parent=f"projects/{self.project_id}",
                read_session={"table": table, "data_format": "ARROW"},
                max_stream_count=max(1, parallelism))
            streams = [s.name for s in session.streams]
        except ImportError:
            def gated():
                src._storage_client()  # raises the clear ImportError

            return [gated]
        if not streams:
            return [lambda: {"_empty": []}]
        return [lambda s=s: read_stream(s) for s in streams]
