# Copied from ray_tpu/data/__init__.py (ray_tpu -> ray_tpu_torch).
"""ray_tpu_torch.data — streaming distributed datasets (reference:
python/ray/data/read_api.py public surface).
"""

from __future__ import annotations

import builtins
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data import aggregate
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import (
    ActorPoolStrategy, Dataset, GroupedData, MaterializedDataset, from_blocks)
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data._internal.logical import Read
from ray_tpu_torch.data import datasource as _ds

__all__ = [
    "Dataset", "MaterializedDataset", "DataIterator", "GroupedData",
    "ActorPoolStrategy", "BlockAccessor", "BlockMetadata", "aggregate",
    "range", "range_tensor", "from_items", "from_numpy", "from_pandas",
    "from_arrow", "from_blocks", "read_parquet", "read_csv", "read_json",
    "read_text", "read_binary_files", "read_numpy", "read_datasource",
    "read_tfrecords", "read_sql", "read_images", "read_webdataset",
    "read_mongo", "read_bigquery", "from_torch",
    "DataContext",
]



def read_datasource(source: _ds.Datasource, *,
                    parallelism: Optional[int] = None) -> Dataset:
    if parallelism is None:
        from ray_tpu_torch.data.context import DataContext

        parallelism = DataContext.get_current().read_parallelism
    return Dataset(Read(source.get_read_tasks(parallelism),
                        name=source.name))


def range(n: int, *, parallelism: Optional[int] = None) -> Dataset:  # noqa: A001
    return read_datasource(_ds.RangeDatasource(n), parallelism=parallelism)


def range_tensor(n: int, *, shape: tuple = (1,),
                 parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(
        _ds.RangeDatasource(n, tensor_shape=tuple(shape), column="data"),
        parallelism=parallelism)


def from_items(items: List[Any], *, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(_ds.ItemsDatasource(list(items)),
                           parallelism=parallelism)


def from_numpy(arrays, column: str = "data") -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    return from_blocks([{column: a} for a in arrays])


def from_pandas(dfs) -> Dataset:
    import pyarrow as pa

    if not isinstance(dfs, list):
        dfs = [dfs]
    return from_blocks([
        pa.Table.from_pandas(df, preserve_index=False) for df in dfs])


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return from_blocks(list(tables))


def read_parquet(paths, *, parallelism: Optional[int] = None, **kw) -> Dataset:
    return read_datasource(_ds.ParquetDatasource(paths, **kw),
                           parallelism=parallelism)


def read_csv(paths, *, parallelism: Optional[int] = None, **kw) -> Dataset:
    return read_datasource(_ds.CSVDatasource(paths, **kw),
                           parallelism=parallelism)


def read_json(paths, *, parallelism: Optional[int] = None, **kw) -> Dataset:
    return read_datasource(_ds.JSONDatasource(paths, **kw),
                           parallelism=parallelism)


def read_text(paths, *, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(_ds.TextDatasource(paths),
                           parallelism=parallelism)


def read_binary_files(paths, *, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(_ds.BinaryDatasource(paths),
                           parallelism=parallelism)


def read_numpy(paths, *, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(_ds.NumpyDatasource(paths),
                           parallelism=parallelism)


def read_tfrecords(paths, *, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(_ds.TFRecordDatasource(paths),
                           parallelism=parallelism)


def read_images(paths, *, size=None, mode: str = "RGB",
                parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(_ds.ImageDatasource(paths, size=size, mode=mode),
                           parallelism=parallelism)


def read_sql(sql: str, connection_factory, *,
             parallelism: Optional[int] = None) -> Dataset:
    """Read a SQL query through a DBAPI2 connection factory (reference:
    read_api.py:1902 read_sql). ``connection_factory`` is a zero-arg
    callable returning a fresh connection (e.g.
    ``lambda: sqlite3.connect(path)``) so every read task can connect from
    its own worker process."""
    return read_datasource(_ds.SQLDatasource(sql, connection_factory),
                           parallelism=parallelism)


def read_webdataset(paths, *, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(_ds.WebDatasetDatasource(paths),
                           parallelism=parallelism)


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline=None, parallelism: Optional[int] = None) -> Dataset:
    """Read a MongoDB collection (reference: read_api.py read_mongo;
    gated — requires ``pymongo`` at read time)."""
    return read_datasource(
        _ds.MongoDatasource(uri, database, collection, pipeline=pipeline),
        parallelism=parallelism)


def read_bigquery(project_id: str, *, query: Optional[str] = None,
                  dataset: Optional[str] = None,
                  parallelism: Optional[int] = None) -> Dataset:
    """Read a BigQuery query/dataset (reference: read_api.py
    read_bigquery; gated — requires ``google-cloud-bigquery``)."""
    return read_datasource(
        _ds.BigQueryDatasource(project_id, query=query, dataset=dataset),
        parallelism=parallelism)


def from_torch(torch_dataset) -> Dataset:
    """Materialize a (map-style) torch Dataset (reference:
    data/read_api.py from_torch)."""
    items = []
    for i in builtins.range(len(torch_dataset)):
        sample = torch_dataset[i]
        if isinstance(sample, tuple) and len(sample) == 2:
            items.append({"item": np.asarray(sample[0]),
                          "label": np.asarray(sample[1])})
        else:
            items.append({"item": np.asarray(sample)})
    return from_blocks([
        {k: np.stack([it[k] for it in items[s:s + 1000]])
         for k in items[0]}
        for s in builtins.range(0, len(items), 1000)])
