"""VisnExtraction: the adapter of model-computed features.

Counterpart of ``vltk_tpu/adapters/extraction.py``. Subclasses declare
``schema()``, ``setup()`` (build the model; ``(bundle, model_config)``) and
``forward(model, batch)`` (run it on a host batch; one entry a row), or the
two halves ``forward_dispatch`` (queue the device work) and
``forward_collect`` (fetch it). ``extract()`` walks the image files of a
vision dataset and writes ``{datadir}/{dataset}/{name}/{split}.arrow`` with
``model_config``, ``processor_args`` and ``dataset`` in its metadata.

The pipeline is the JAX package's: a producer thread decodes batch k + 1 on
a pool of decode threads while the device runs batch k; every batch has the
model's batch size (the last one is filled with copies of its last image,
dropped after the forward); with the two-phase forward, batch k + 1 is
queued on the device before batch k is fetched and written. The model runs
on CUDA unless ``device="cpu"`` is passed. With ``host_workers > 1`` a
host-only adapter (``host_only = True``: its ``setup`` builds no model on
the card) runs each split over that many processes
(``data/hostpipe.py:run_sharded_split``; the stage seconds land on
``adapter.host_stats``); any other adapter raises ``ValueError`` then.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.base import Adapter
from vltk_tpu_torch.config import VisionConfig
from vltk_tpu_torch.data.loader import prefetched
from vltk_tpu_torch.inspection import collect_args_to_func


class VisnExtraction(Adapter):
    default_processor: Optional[VisionConfig] = None
    dataset: Optional[str] = None  # the VisnDataset whose images are read
    model_batch_size: int = 8
    prefetch_depth: int = 2
    decode_workers: int = 8  # decode threads (PIL releases the GIL)

    @classmethod
    def full_schema(cls, **kwargs) -> Dict[str, Any]:
        from vltk_tpu_torch.features import Features

        schema = super().full_schema(**kwargs)
        schema.setdefault(V.imgid, Features.Imgid())
        return schema

    @classmethod
    def collate(cls, entries: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Per-image processor outputs -> one host batch (arrays stacked)."""
        out: Dict[str, Any] = {}
        for key in entries[0] if entries else ():
            vals = [e[key] for e in entries]
            out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        return out

    @classmethod
    def setup(cls, **kwargs):  # pragma: no cover - abstract
        """-> (model bundle, model_config dict). Called once an extract()."""
        raise NotImplementedError

    @classmethod
    def forward(cls, model, batch: Mapping[str, Any], **kwargs):  # pragma: no cover
        """Run the model on a host batch -> one entry dict a row."""
        raise NotImplementedError

    forward_dispatch = None
    forward_collect = None

    @classmethod
    def extract(
        cls,
        datadir: str,
        dataset_name: Optional[str] = None,
        splits: Optional[Sequence[str]] = None,
        img_format: str = "jpg",
        host_workers: int = 0,
        **kwargs,
    ) -> Dict[str, Adapter]:
        """Extract the images of ``dataset_name`` (``cls.dataset`` when
        None), one Arrow file a split. ``kwargs`` reach ``setup``,
        ``schema`` and ``forward`` as each declares them (``device``,
        ``checkpoint``, ``preset``, config overrides, ...)."""
        from vltk_tpu_torch.adapters import Adapters

        dataset_name = dataset_name or cls.dataset
        if dataset_name is None:
            raise ValueError(f"{cls.name()}.extract needs a dataset name")
        if host_workers > 1 and not getattr(cls, "host_only", False):
            raise ValueError(
                f"{cls.name()}: host_workers={host_workers} requires a host-only adapter (setup() must not build "
                "a model on the card: each worker process would claim it). Device extraction keeps the threaded "
                "double-buffered pipeline; see data/hostpipe.py."
            )
        vdset = Adapters.get(dataset_name)
        base = os.path.join(datadir, dataset_name)
        if splits is None:
            if not os.path.isdir(base):
                raise FileNotFoundError(f"dataset directory {base!r} does not exist")
            splits = [
                d for d in sorted(os.listdir(base))
                if os.path.isdir(os.path.join(base, d)) and d in _known_splits()
            ] or [None]
        split_files: Dict[str, Dict[str, str]] = {}
        for split in splits:
            id2path = vdset.load_imgid2path(datadir, split)
            if img_format:
                id2path = {k: p for k, p in id2path.items() if p.lower().endswith(img_format.lower())}
            if id2path:
                split_files[split or "train"] = id2path
        if not split_files:
            raise FileNotFoundError(f"no images found for dataset {dataset_name} under {base}")

        processor_cfg = cls.default_processor or VisionConfig()
        processor = processor_cfg.build()
        model, model_config = cls.setup(**collect_args_to_func(cls.setup, kwargs))
        schema = cls.full_schema(**kwargs)
        fwd_kwargs = collect_args_to_func(cls.forward, kwargs)
        out: Dict[str, Adapter] = {}
        for split, id2path in split_files.items():
            meta = {"model_config": model_config, "processor_args": processor_cfg.to_dict(), "dataset": base}
            out_path = os.path.join(base, cls.name(), f"{split}.arrow")
            if host_workers > 1:
                from vltk_tpu_torch.data.hostpipe import run_sharded_split

                adapter, stats = run_sharded_split(
                    cls, id2path, out_path, num_workers=host_workers, batch_size=cls.model_batch_size,
                    setup_kwargs=collect_args_to_func(cls.setup, kwargs), schema_kwargs=kwargs, extra_metadata=meta,
                )
                adapter.host_stats = stats
            else:
                adapter = cls._write_entries(cls._run_split(id2path, processor, model, fwd_kwargs), schema, out_path,
                                             meta)
            adapter._split = split
            out[split] = adapter
        return out

    @classmethod
    def _run_split(cls, id2path: Mapping[str, str], processor, model, fwd_kwargs: Mapping[str, Any]) -> Iterator[Dict[str, Any]]:
        """Host decode pipeline -> device batches -> one entry an image."""
        items = sorted(id2path.items())
        bs = cls.model_batch_size
        decode_pool = ThreadPoolExecutor(max_workers=max(cls.decode_workers, 1))

        def decode_one(item):
            imgid, path = item
            entry = processor(path)
            entry[V.imgid] = imgid
            return entry

        def load_batch(chunk):
            # the last chunk is filled with copies of its last image so the
            # model sees one batch shape; the copies are dropped after it
            padded = list(chunk) + [chunk[-1]] * (bs - len(chunk))
            batch = cls.collate(list(decode_pool.map(decode_one, padded)))
            batch["n_real"] = len(chunk)
            return batch

        pipelined = cls.forward_dispatch is not None and cls.forward_collect is not None
        pending = None  # (device state, n_real): one batch in flight
        batches = prefetched(lambda: (load_batch(items[i : i + bs]) for i in range(0, len(items), bs)),
                             cls.prefetch_depth)
        try:
            for batch in batches:
                n_real = batch.pop("n_real")
                if not pipelined:
                    yield from cls.forward(model, batch, **fwd_kwargs)[:n_real]
                    continue
                state = cls.forward_dispatch(model, batch, **fwd_kwargs)
                if pending is not None:
                    yield from cls.forward_collect(model, pending[0])[: pending[1]]
                pending = (state, n_real)
            if pending is not None:
                yield from cls.forward_collect(model, pending[0])[: pending[1]]
        finally:
            batches.close()  # joins the producer before its pool goes
            decode_pool.shutdown(wait=True)


def _known_splits():
    return V.SPLITALIASES | {s + y for s in V.SPLITALIASES for y in ("2014", "2015", "2017")}
