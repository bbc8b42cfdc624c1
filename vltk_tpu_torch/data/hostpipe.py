"""Multi-process host ETL: process-pool decode -> collate -> Arrow shards ->
an ordered merge, with the seconds of each stage.

Counterpart of ``vltk_tpu/data/hostpipe.py``. One Python process decodes
at about one core's rate; this spreads one split's host ETL over
``num_workers`` processes:

* the sorted ``(imgid, path)`` list is cut into ``num_workers``
  CONTIGUOUS shards; each worker process decodes, collates and forwards
  its shard's batches and streams the rows into its own Arrow shard file
  (``Adapter._write_entries``, row map and counters in its metadata);
* the parent concatenates the shards in shard order, so the rows are in
  the order of the single-process run by construction, merges their
  metadata (row maps re-offset, first occurrence kept; ``*_frequencies``
  counters summed) and writes the result crash-atomically
  (``Adapter._write_table``);
* each worker reports its decode / collate / forward / write seconds.

``num_workers <= 1`` runs the same worker function inline: the
single-process run the tests hold the pooled one against.

Workers are started with ``spawn``: each child re-imports the adapter
class by module path (``_adapter_spec``), so the class must live at module
scope, and it must be HOST-ONLY (``host_only = True``): ``setup()`` builds
no model on the card, as every child would claim it. Importing this module
and the adapter builds nothing and touches no device. Each child runs
torch with one intra-op thread (``torch.set_num_threads(1)``), so the
workers' threads do not multiply. Device extraction keeps the threaded,
double-buffered pipeline of ``adapters/extraction.py``.
"""

from __future__ import annotations

import importlib
import os
import time
import types
from multiprocessing import get_context
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.frcnn import FRCNN as FRCNNAdapter
from vltk_tpu_torch.config import VisionConfig
from vltk_tpu_torch.utils.base import set_metadata


class HostDecodeFRCNN(FRCNNAdapter):
    """The FRCNN adapter's host plane with the model step stubbed: JPEG
    decode -> uint8 raw-canvas collate -> zero rows of the real packed
    output's shape on the CPU. Everything the host pays for is real; only
    the model's compute is left out."""

    _name = "hostdecodefrcnn"
    host_only = True
    # the packed rows' geometry (the real extractor's)
    stub_detections: int = 36
    stub_dim: int = 2048

    @classmethod
    def setup(cls, **kwargs):
        dim = cls.stub_dim + 6  # features + box (4) + object id + attribute id

        def step(raw_images: torch.Tensor, raw_sizes: torch.Tensor) -> torch.Tensor:
            return torch.zeros((raw_images.shape[0], cls.stub_detections, dim), dtype=torch.float32)

        bundle = {"step": step, "device": torch.device("cpu"), "cfg": types.SimpleNamespace(int8=False)}
        return bundle, {"model": "host-decode-stub"}

    @classmethod
    def full_schema(cls, **kwargs):
        kwargs.setdefault("max_detections", cls.stub_detections)
        kwargs.setdefault("visual_dim", cls.stub_dim)
        return super().full_schema(**kwargs)


class TinyHostDecodeFRCNN(HostDecodeFRCNN):
    """The stub at a small canvas, for quick tests."""

    _name = "tinyhostdecodefrcnn"
    raw_canvas = (96, 96)
    stub_detections = 4
    stub_dim = 16
    model_batch_size = 4


def _resolve_adapter(spec: str):
    mod_name, _, qualname = spec.partition(":")
    obj = importlib.import_module(mod_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _adapter_spec(cls) -> str:
    spec = f"{cls.__module__}:{cls.__qualname__}"
    if cls.__module__ == "__main__" or "<locals>" in cls.__qualname__:
        raise ValueError(
            f"hostpipe adapters must be importable at module scope (got {spec}); spawned workers re-import the class"
        )
    return spec


def _shard_worker(payload: Tuple) -> Dict[str, Any]:
    """One shard: decode -> collate -> host forward -> Arrow shard file, in
    a child process (or inline). Returns the shard's path and its stage
    seconds."""
    spec, items, shard_path, batch_size, setup_kwargs, schema_kwargs, in_child = payload
    if in_child:
        torch.set_num_threads(1)
    cls = _resolve_adapter(spec)
    processor = (cls.default_processor or VisionConfig()).build()
    model, _ = cls.setup(**setup_kwargs)
    schema = cls.full_schema(**schema_kwargs)
    stats = {"decode_s": 0.0, "collate_s": 0.0, "forward_s": 0.0, "n_images": len(items), "n_batches": 0}

    def entries():
        for i in range(0, len(items), batch_size):
            chunk = items[i : i + batch_size]
            # the last batch is filled with copies of its last image, as in
            # the extraction pipeline; the copies are dropped after forward
            padded = list(chunk) + [chunk[-1]] * (batch_size - len(chunk))
            t0 = time.perf_counter()
            batch_entries = []
            for imgid, path in padded:
                entry = processor(path)
                entry[V.imgid] = imgid
                batch_entries.append(entry)
            stats["decode_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            batch = cls.collate(batch_entries)
            stats["collate_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            outs = cls.forward(model, batch)
            stats["forward_s"] += time.perf_counter() - t0
            stats["n_batches"] += 1
            yield from outs[: len(chunk)]

    t0 = time.perf_counter()
    cls._write_entries(entries(), schema, shard_path)
    total = time.perf_counter() - t0
    stats["write_s"] = max(total - stats["decode_s"] - stats["collate_s"] - stats["forward_s"], 0.0)
    stats["wall_s"] = total
    return {"shard_path": shard_path, "stats": stats}


def _merge_shards(cls, shard_paths: Sequence[str], out_path: str, extra_metadata: Optional[Dict[str, Any]] = None):
    """Concatenate the shard tables in shard order and merge their
    metadata: row maps re-offset (first occurrence kept, as
    ``_write_entries`` keeps it), ``*_frequencies`` counters summed, any
    other key of the first shard (the ``huggingface`` column types) kept."""
    tables = []
    img_to_row_map: Dict[str, int] = {}
    freqs: Dict[str, Dict[str, int]] = {}
    kept: Dict[bytes, bytes] = {}
    offset = 0
    for i, path in enumerate(shard_paths):
        shard = cls._load_one_arrow(path)
        for imgid, row in sorted(shard.metadata.get("img_to_row_map", {}).items(), key=lambda kv: kv[1]):
            img_to_row_map.setdefault(imgid, row + offset)
        for key, value in shard.metadata.items():
            if key.endswith("_frequencies") and isinstance(value, dict):
                merged = freqs.setdefault(key, {})
                for s, n in value.items():
                    merged[s] = merged.get(s, 0) + n
        if i == 0:
            kept = {k: v for k, v in (shard.table.schema.metadata or {}).items()
                    if k != b"img_to_row_map" and not k.endswith(b"_frequencies")}
        tables.append(shard.table.replace_schema_metadata(None))
        offset += shard.num_rows

    table = pa.concat_tables(tables).replace_schema_metadata(kept)
    meta: Dict[str, Any] = {"img_to_row_map": img_to_row_map}
    meta.update(freqs)
    if extra_metadata:
        meta.update(extra_metadata)
    return cls._write_table(set_metadata(table, meta), out_path)


def run_sharded_split(
    cls,
    id2path: Mapping[str, str],
    out_path: str,
    num_workers: int = 0,
    batch_size: Optional[int] = None,
    setup_kwargs: Optional[Dict[str, Any]] = None,
    schema_kwargs: Optional[Dict[str, Any]] = None,
    extra_metadata: Optional[Dict[str, Any]] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """One split's host ETL over ``num_workers`` processes (inline for
    ``num_workers <= 1``; never more workers than images). Returns
    ``(adapter, stats)``: ``stats["aggregate"]`` sums the stage seconds
    and gives the images, batches, workers, wall seconds and images/s;
    ``stats["per_worker"]`` each worker's."""
    spec = _adapter_spec(cls)
    items = sorted(id2path.items())
    if not items:
        raise ValueError("run_sharded_split: empty id2path")
    bs = int(batch_size or cls.model_batch_size)
    workers = min(max(int(num_workers), 1), len(items))
    pooled = num_workers > 1
    setup_kwargs = dict(setup_kwargs or {})
    schema_kwargs = dict(schema_kwargs or {})

    # contiguous shards keep the sorted order under an in-order concat
    bounds = np.linspace(0, len(items), workers + 1).astype(int)
    payloads = [
        (spec, items[bounds[w] : bounds[w + 1]], f"{out_path}.shard{w:04d}", bs, setup_kwargs, schema_kwargs, pooled)
        for w in range(workers)
        if bounds[w + 1] > bounds[w]
    ]

    t0 = time.perf_counter()
    if not pooled:
        results = [_shard_worker(p) for p in payloads]
    else:
        with get_context("spawn").Pool(processes=len(payloads)) as pool:
            results = pool.map(_shard_worker, payloads)  # in payload order
    wall = time.perf_counter() - t0

    shard_paths = [r["shard_path"] for r in results]
    try:
        adapter = _merge_shards(cls, shard_paths, out_path, extra_metadata)
    finally:
        for p in shard_paths:
            try:
                os.remove(p)
            except OSError:
                pass

    per_worker: List[Dict[str, Any]] = [r["stats"] for r in results]
    agg = {k: round(sum(s[k] for s in per_worker), 4) for k in ("decode_s", "collate_s", "forward_s", "write_s")}
    agg.update(
        n_images=len(items),
        n_batches=sum(s["n_batches"] for s in per_worker),
        workers=len(per_worker),
        wall_s=round(wall, 4),
        img_per_s=round(len(items) / wall, 2) if wall > 0 else float("inf"),
    )
    return adapter, {"aggregate": agg, "per_worker": per_worker}
