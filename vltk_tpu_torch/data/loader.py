"""Batch loaders and the host -> device feed: counterpart of
``vltk_tpu/data/loader.py``.

* Entries are fixed-shape already (padded at write or entry time), so
  ``collate`` is a plain ``np.stack`` and every batch of a run has one
  shape.
* ``_BaseLoader`` fetches entries on a thread pool into a bounded prefetch
  queue, in a seeded order per epoch, optionally one host's shard of it,
  and resumes mid-epoch without fetching the skipped entries
  (``iter_from``).
* ``transpose_vl`` flattens an image-first batch (B images x T sentences)
  to a sentence-major one of a static size.
* ``device_put_iter`` moves batches to the device: pinned host buffers,
  copies queued on a side CUDA stream, the consumer's stream waiting on an
  event, so batch i + 1 moves while step i runs.

Eval loaders never shuffle.
"""

from __future__ import annotations

import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, FrozenSet, Iterable, Iterator, List, Optional

import numpy as np
import torch

from vltk_tpu_torch import DeviceLike, resolve_device


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


def prefetched(make_items: Callable[[], Iterable[Any]], depth: int) -> Iterator[Any]:
    """Yield the items of ``make_items()``, made on a producer thread at
    most ``depth`` ahead of the consumer. The producer's exception is
    raised here. When the consumer stops early, the stop event and the put
    timeout end the producer, which is joined before this returns."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            items = iter(make_items())
            while not stop.is_set():
                item = next(items, _DONE)
                if not offer(item) or item is _DONE:
                    return
        except BaseException as exc:  # handed to the consumer
            offer(_Raised(exc))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item
    finally:
        stop.set()
        while True:  # drain, so a blocked put wakes at once
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join()


def collate(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack the keys every entry has; strings and objects become lists."""
    batch: Dict[str, Any] = {}
    keys = set(entries[0])
    for e in entries[1:]:
        keys &= set(e)
    for k in sorted(keys):
        vals = [e[k] for e in entries]
        first = vals[0]
        if isinstance(first, str):
            batch[k] = vals
        elif isinstance(first, np.ndarray) or np.isscalar(first):
            arrs = [np.asarray(v) for v in vals]
            if all(a.shape == arrs[0].shape and a.dtype == arrs[0].dtype for a in arrs):
                batch[k] = np.stack(arrs)
            else:
                # a ragged key is a bug upstream (pad at write or entry
                # time); keep the list so debugging can go on, and say so
                shapes = sorted({(a.shape, str(a.dtype)) for a in arrs})
                warnings.warn(
                    f"collate: key '{k}' is not fixed-shape across the batch ({shapes[:4]}); yielding a list. "
                    "Pad this key at entry time: list-valued batch keys cannot be fed to the device.",
                    RuntimeWarning,
                    stacklevel=2,
                )
                batch[k] = vals
        else:
            batch[k] = vals
    return batch


# image-side keys of raw dict batches, for ``transpose_vl`` without the
# dataset's own set
_IMAGE_SIDE_KEYS = frozenset({
    "features", "boxes", "boxes_mask", "image", "gt_boxes", "gt_boxes_mask", "tokenbox", "visual_attention_mask",
})


def transpose_vl(batch: Dict[str, Any], max_size: int = 512,
                 image_side_keys: Optional[FrozenSet[str]] = None) -> Dict[str, Any]:
    """Image-first batch (B, T, ...) -> sentence-major batch of the static
    leading size ``min(B*T, max_size)`` with a ``sentence_mask`` of the real
    rows (padded slots repeat row 0). Keys in ``image_side_keys`` (the
    dataset's, else a name table) repeat per sentence instead of
    flattening."""
    if image_side_keys is None:
        image_side_keys = _IMAGE_SIDE_KEYS
    text_mask = np.asarray(batch["text_mask"])
    b, t = text_mask.shape
    out_size = min(b * t, max_size)
    valid_idx = np.flatnonzero(text_mask.reshape(-1).astype(bool))[:out_size]
    n_valid = valid_idx.shape[0]
    idx = np.zeros((out_size,), np.int64)
    idx[:n_valid] = valid_idx
    img_idx = idx // t
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if k in ("text_mask", "n_texts"):
            continue
        if isinstance(v, np.ndarray):
            if v.ndim >= 2 and v.shape[:2] == (b, t) and k not in image_side_keys:
                out[k] = v.reshape(b * t, *v.shape[2:])[idx]
            elif v.shape[:1] == (b,):
                out[k] = v[img_idx]
            else:
                out[k] = v
        elif isinstance(v, list) and len(v) == b:
            out[k] = [v[i] for i in img_idx]
        else:
            out[k] = v
    mask = np.zeros((out_size,), np.int32)
    mask[:n_valid] = 1
    out["sentence_mask"] = mask
    return out


class _BaseLoader:
    """Fixed-size batches of a dataset's entries."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, num_workers: int = 0, drop_last: bool = True,
                 seed: int = 0, prefetch_depth: int = 2, shard: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = int(num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_depth = prefetch_depth
        # (rank, world): this host's stride of the seeded global order
        self.shard = shard
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def iter_from(self, skip_batches: int) -> Iterator[Dict[str, Any]]:
        """This epoch's order from batch ``skip_batches`` on, the skipped
        entries never fetched. Only the returned iterator skips."""
        return self._iterate(int(skip_batches))

    def _shard_size(self) -> int:
        n = len(self.dataset)
        if self.shard is None:
            return n
        return -(-n // self.shard[1])  # wrapped: every host the same count

    def __len__(self) -> int:
        n = self._shard_size()
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.shard is not None:
            rank, world = self.shard
            # wrap-pad so every host yields the same number of batches
            padded = -(-n // world) * world
            if padded > n:
                order = np.concatenate([order, order[: padded - n]])
            order = order[rank::world]
        return order

    def _batches(self, start_batch: int = 0) -> Iterator[List[int]]:
        order = self._order()
        bs = self.batch_size
        end = len(order) - (len(order) % bs) if self.drop_last else len(order)
        for i in range(start_batch * bs, end, bs):
            chunk = order[i : i + bs]
            if len(chunk):
                yield list(chunk)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self._iterate(0)

    def _iterate(self, start: int) -> Iterator[Dict[str, Any]]:
        if self.num_workers <= 0:
            for chunk in self._batches(start):
                yield collate([self.dataset[i] for i in chunk])
            return
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            yield from prefetched(
                lambda: (collate(list(pool.map(self.dataset.__getitem__, chunk))) for chunk in self._batches(start)),
                self.prefetch_depth,
            )
        finally:
            pool.shutdown(wait=True)


def _config_shard(config, shard: Optional[tuple]) -> Optional[tuple]:
    """The loader's (rank, world): an explicit ``shard`` wins, else
    ``shard_count`` / ``shard_rank`` of the config, the rank taken from
    ``torch.distributed`` when unset and a process group is up, else 0."""
    if shard is not None:
        return shard
    count = getattr(config, "shard_count", None)
    if not count or int(count) <= 1:
        return None
    rank = getattr(config, "shard_rank", None)
    if rank is None:
        dist = torch.distributed
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    rank, count = int(rank), int(count)
    if not 0 <= rank < count:
        raise ValueError(f"shard_rank {rank} outside [0, {count})")
    return (rank, count)


class VisionLoader(_BaseLoader):
    """A config's loader: its batch size, shuffle, threads and last-batch
    rule for training; the eval batch size, in order, on the calling
    thread, the short last batch kept for eval."""

    def __init__(self, config, dataset, train: bool = True, shard: Optional[tuple] = None):
        super().__init__(
            dataset,
            batch_size=config.train_batch_size if train else config.eval_batch_size,
            shuffle=config.shuffle if train else False,
            num_workers=config.num_workers if train else 0,
            drop_last=config.drop_last if train else False,
            prefetch_depth=config.prefetch_depth,
            shard=_config_shard(config, shard),
        )
        self.config = config
        self.train = train


class VisionLanguageLoader(VisionLoader):
    def transposed(self, max_size: int = 512) -> Iterator[Dict[str, Any]]:
        """Sentence-major batches of an image-first dataset."""
        keys = getattr(self.dataset, "image_side_keys", None)
        for batch in self:
            yield transpose_vl(batch, max_size=max_size, image_side_keys=keys)


def _as_tensor(v):
    """A numeric numpy array as a tensor, a tensor as it is, else None."""
    if isinstance(v, np.ndarray) and v.dtype != object:
        return torch.from_numpy(v)
    return v if torch.is_tensor(v) else None


def device_put_iter(loader: Iterable[Dict[str, Any]], keys: Optional[List[str]] = None,
                    device: DeviceLike = None) -> Iterator[Dict[str, Any]]:
    """The loader's batches with their numeric arrays (and tensors) on
    ``device`` (CUDA unless "cpu" is asked for; raises without a card);
    other values pass through. ``keys`` keeps only those keys.

    On CUDA each host array is copied into pinned memory and sent on a side
    stream; the consumer's stream waits on the copy's event and each tensor
    is recorded on it, so batch i + 1 moves while the caller works on
    batch i."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(device=dev) if cuda else None

    def put(batch):
        out = {}
        for k, v in batch.items():
            if keys is not None and k not in keys:
                continue
            t = _as_tensor(v)
            out[k] = v if t is None else t
        if not cuda:
            return {k: v.to(dev) if torch.is_tensor(v) else v for k, v in out.items()}, None
        with torch.cuda.stream(side):
            for k, v in out.items():
                if torch.is_tensor(v) and v.device.type == "cpu":
                    out[k] = v.pin_memory().to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def hand_out(put_batch):
        out, ready = put_batch
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for v in out.values():
                if torch.is_tensor(v):
                    v.record_stream(consumer)
        return out

    it = iter(loader)
    try:
        pending = put(next(it))
    except StopIteration:
        return
    for batch in it:
        nxt = put(batch)  # queued before the caller gets the previous one
        yield hand_out(pending)
        pending = nxt
    yield hand_out(pending)
