"""Adapter base: an Arrow table with its metadata.

Counterpart of ``vltk_tpu/adapters/base.py``. An adapter is a
class-per-dataset ETL unit: subclasses declare ``schema()`` and
``forward()``; the base class owns

* the Arrow write (``_write_entries``): rows streamed into record batches
  of ``WRITE_BATCH_SIZE``, the schema metadata (``img_to_row_map``, a
  ``{column}_frequencies`` counter for every string column that is not an
  id, the ``huggingface`` key of the column types), and a crash-atomic
  replace of the file through a same-directory temporary;
* the zero-copy load (``load`` / ``_load_one_arrow``: ``pa.memory_map`` and
  the IPC stream reader);
* random access by image id (``get`` / ``get_idx`` / ``has`` / ``imgids``)
  and subsets with a remapped row map (``imgid_filter``).

The tables are the JAX package's: each reads the other's files. A row's
tensor columns (``ArrayXD`` of a fixed shape) come back as read-only numpy
views of the mapped file where the JAX package returns nested lists; the
loader turns both into the same arrays. ``download`` raises: the port
fetches nothing.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import Counter
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np
import pyarrow as pa

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.features import EXTENSION_META_KEY, ArrayXD, arrow_schema, is_stringy
from vltk_tpu_torch.inspection import collect_args_to_func
from vltk_tpu_torch.utils.base import get_metadata, set_metadata

_ID_KEYS = {V.imgid, V.qid, V.filepath, V.split, V.img, V.text}
WRITE_BATCH_SIZE = 1024


class Adapter:
    """An Arrow table and its metadata, made by a subclass's ETL."""

    filters: Sequence[str] = ()  # substrings of JSON file names extract() skips
    _batch_size: int = WRITE_BATCH_SIZE

    def __init__(self, table: pa.Table, split: Optional[str] = None, metadata: Optional[Dict[str, Any]] = None):
        self._table = table
        self._split = split
        meta = metadata if metadata is not None else get_metadata(table)
        self._metadata = meta
        self._img_to_row_map: Dict[str, int] = dict(meta.get("img_to_row_map") or {})
        self._readers: Optional[Dict[str, Callable[[int], Any]]] = None
        # metadata entries become attributes (``answer_frequencies``, ...)
        for key, value in meta.items():
            if key == "huggingface":
                continue
            safe = key.replace("-", "_")
            if not hasattr(self, safe):
                setattr(self, safe, value)

    @classmethod
    def name(cls) -> str:
        return getattr(cls, "_name", None) or cls.__name__.lower()

    def __repr__(self) -> str:
        return f"{type(self).__name__}(split={self._split!r}, rows={self.num_rows}, columns={self.column_names})"

    # -- table access ---------------------------------------------------------

    @property
    def table(self) -> pa.Table:
        return self._table

    @property
    def split(self) -> Optional[str]:
        return self._split

    @property
    def num_rows(self) -> int:
        return self._table.num_rows

    def __len__(self) -> int:
        return self.num_rows

    @property
    def column_names(self) -> List[str]:
        return list(self._table.column_names)

    @property
    def metadata(self) -> Dict[str, Any]:
        return self._metadata

    @property
    def img_to_row_map(self) -> Dict[str, int]:
        return self._img_to_row_map

    @property
    def imgids(self) -> List[str]:
        return list(self._img_to_row_map.keys())

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.get_idx(idx)

    def get_idx(self, idx: int) -> Dict[str, Any]:
        """The row at ``idx`` as a dict: Python values, tensor columns as
        numpy views."""
        if not 0 <= idx < self.num_rows:
            raise IndexError(idx)
        if self._readers is None:
            self._readers = {f.name: _column_reader(f, self._table.column(f.name)) for f in self._table.schema}
        return {name: read(idx) for name, read in self._readers.items()}

    def has(self, img_id: str) -> bool:
        return str(img_id) in self._img_to_row_map

    def get(self, img_id: str) -> Dict[str, Any]:
        return self.get_idx(self._img_to_row_map[str(img_id)])

    def __iter__(self):
        for i in range(self.num_rows):
            yield self.get_idx(i)

    def imgid_filter(self, keep: Iterable[str]) -> "Adapter":
        """The rows whose imgid is in ``keep``, with the row map remapped."""
        keep = {str(k) for k in keep}
        rows = sorted(idx for img, idx in self._img_to_row_map.items() if img in keep)
        sub = self._table.take(pa.array(rows, type=pa.int64()))
        old_by_row = {idx: img for img, idx in self._img_to_row_map.items()}
        meta = dict(self._metadata)
        meta["img_to_row_map"] = {old_by_row[r]: i for i, r in enumerate(rows)}
        out = type(self).__new__(type(self))
        Adapter.__init__(out, sub, split=self._split, metadata=meta)
        return out

    # -- metadata counters ----------------------------------------------------

    @classmethod
    def _counter_columns(cls, schema: Mapping[str, Any]) -> List[str]:
        """String columns that are no id get a frequency counter."""
        return [name for name, feat in schema.items() if name not in _ID_KEYS and is_stringy(feat)]

    @staticmethod
    def _update_counters(counters: Mapping[str, Counter], entry: Mapping[str, Any]) -> None:
        for col, counter in counters.items():
            value = entry.get(col)
            if isinstance(value, str):
                counter[value] += 1
            elif isinstance(value, (list, tuple)):
                for v in _flatten_strings(value):
                    counter[v] += 1

    # -- write ----------------------------------------------------------------

    @classmethod
    def _write_entries(
        cls,
        entries: Iterable[Mapping[str, Any]],
        schema: Dict[str, Any],
        out_path: str,
        extra_metadata: Optional[Dict[str, Any]] = None,
    ) -> "Adapter":
        """Stream ``entries`` into an Arrow file at ``out_path`` with the
        row map and counters in the schema metadata, then load it."""
        counters = {c: Counter() for c in cls._counter_columns(schema)}
        img_to_row_map: Dict[str, int] = {}
        pa_schema = arrow_schema(schema)
        batches: List[pa.RecordBatch] = []
        pending: Dict[str, List] = {k: [] for k in schema}
        row = 0

        def flush():
            if any(pending.values()):
                cols = [_column_array(schema[k], pending[k], pa_schema.field(k).type) for k in schema]
                batches.append(pa.RecordBatch.from_arrays(cols, schema=pa_schema))
                for k in pending:
                    pending[k] = []

        for entry in entries:
            if entry is None:
                continue
            if V.imgid in schema:
                img_to_row_map.setdefault(str(entry.get(V.imgid, row)), row)
            cls._update_counters(counters, entry)
            for k in schema:
                pending[k].append(entry.get(k))
            row += 1
            if row % cls._batch_size == 0:
                flush()
        flush()

        table = pa.Table.from_batches(batches, schema=pa_schema)
        meta: Dict[str, Any] = {"img_to_row_map": img_to_row_map}
        for col, counter in counters.items():
            meta[f"{col}_frequencies"] = dict(counter)
        if extra_metadata:
            meta.update(extra_metadata)
        return cls._write_table(set_metadata(table, meta), out_path)

    @classmethod
    def _write_table(cls, table: pa.Table, out_path: str) -> "Adapter":
        """Write ``table`` as an Arrow IPC stream at ``out_path``, then load
        it. Crash-atomic: a process dying mid-write leaves neither a
        truncated file where load() looks nor a damaged earlier extraction."""
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        tmp_path = f"{out_path}.{os.getpid()}.tmp"
        try:
            with pa.OSFile(tmp_path, "wb") as f:
                with pa.ipc.new_stream(f, table.schema) as writer:
                    writer.write_table(table)
            os.replace(tmp_path, out_path)
        except BaseException:
            try:
                os.remove(tmp_path)
            except OSError:
                pass
            raise
        return cls._load_one_arrow(out_path)

    # -- load -----------------------------------------------------------------

    @classmethod
    def _load_one_arrow(cls, path: str, split: Optional[str] = None) -> "Adapter":
        """Memory-mapped IPC stream read: no copy of the file's buffers."""
        table = pa.ipc.open_stream(pa.memory_map(path)).read_all()
        inst = cls.__new__(cls)
        Adapter.__init__(inst, table, split=split)
        return inst

    @classmethod
    def load(cls, datadir: str, split: Optional[str] = None) -> Union["Adapter", Dict[str, "Adapter"], None]:
        """The extracted Arrow files under ``{datadir}/{name}/``: one
        adapter when ``split`` is given (None when that split has no file)
        or only one file exists, else a dict split -> adapter."""
        base = os.path.join(datadir, cls.name())
        if not os.path.isdir(base):
            return None
        found: Dict[str, Adapter] = {}
        for fname in sorted(os.listdir(base)):
            if not fname.endswith(".arrow"):
                continue
            fsplit = os.path.splitext(fname)[0]
            if split is not None and fsplit != split and fname != "annotations.arrow":
                continue
            found[fsplit] = cls._load_one_arrow(os.path.join(base, fname), split=fsplit)
        if not found:
            return None
        if split is not None:
            return found.get(split)
        if len(found) == 1:
            return next(iter(found.values()))
        return found

    @classmethod
    def download(cls, datadir: str) -> Optional[str]:
        raise NotImplementedError(
            f"{cls.name()}: the port downloads nothing; put the raw files under {os.path.join(datadir, cls.name())}"
        )

    # -- subclass surface -----------------------------------------------------

    @classmethod
    def schema(cls, **kwargs) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    @classmethod
    def forward(cls, *args, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    @classmethod
    def full_schema(cls, **kwargs) -> Dict[str, Any]:
        """``schema()`` (given the keyword arguments it declares) over the
        class's base columns."""
        base = dict(getattr(cls, "_base_features", {}))
        base.update(cls.schema(**collect_args_to_func(cls.schema, kwargs)))
        return base


def _flatten_strings(value) -> Iterable[str]:
    if isinstance(value, str):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _flatten_strings(v)


def _column_array(feature, values: List[Any], storage: pa.DataType) -> pa.Array:
    """One column of a record batch. A fixed-shape tensor column whose rows
    all have its shape is built from one stacked numpy array; the rest
    through pyarrow's conversion of Python values."""
    if isinstance(feature, ArrayXD):
        shape = tuple(feature.shape)
        if None not in shape and values and all(v is not None and np.shape(v) == shape for v in values):
            flat = np.stack([np.asarray(v, feature.dtype) for v in values]).reshape(-1)
            arr: pa.Array = pa.array(flat)
            for dim in reversed(shape):
                arr = pa.ListArray.from_arrays(_offsets(len(arr) // dim, dim), arr)
            return arr
        values = [None if v is None else np.asarray(v, feature.dtype).tolist() for v in values]
    return pa.array(values, type=storage)


def _offsets(n: int, width: int) -> pa.Array:
    return pa.array(np.arange(0, (n + 1) * width, width, dtype=np.int32))


def _column_reader(field: pa.Field, column: pa.ChunkedArray) -> Callable[[int], Any]:
    """Row reader of one column: numpy views for a fixed-shape tensor
    column without nulls (its field carries HF's extension metadata, or its
    type is the extension type when HF ``datasets`` is loaded), Python
    values for everything else."""
    chunks = [c.storage if isinstance(c, pa.ExtensionArray) else c for c in column.chunks]
    meta = field.metadata or {}
    ext = field.type.__arrow_ext_serialize__() if isinstance(field.type, pa.ExtensionType) else meta.get(EXTENSION_META_KEY)
    views = _tensor_views(chunks, ext) if ext is not None else None
    starts = np.cumsum([0] + [len(c) for c in chunks[:-1]]).tolist()

    if views is not None:
        def read_view(i: int):
            k = bisect.bisect_right(starts, i) - 1
            return views[k][i - starts[k]]

        return read_view

    def read(i: int):
        k = bisect.bisect_right(starts, i) - 1
        return chunks[k][i - starts[k]].as_py()

    return read


def _tensor_views(chunks: List[pa.Array], ext_meta: bytes) -> Optional[List[np.ndarray]]:
    """Each chunk as one (rows, *shape) numpy view, or None when a row is
    null or the shape is not fixed."""
    shape, _dtype = json.loads(ext_meta)
    if any(d is None for d in shape):
        return None
    views = []
    for chunk in chunks:
        if chunk.null_count:
            return None
        values = chunk
        for _ in shape:
            if values.null_count:
                return None
            values = values.flatten()
        if len(values) != len(chunk) * int(np.prod(shape)):
            return None
        views.append(values.to_numpy(zero_copy_only=True).reshape(len(chunk), *shape))
    return views
