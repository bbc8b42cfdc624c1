"""Device-memory resilience: counterpart of ``vltk_tpu/utils/memory.py``.

``handle_cuda_oom`` is the JAX package's ``handle_tpu_oom`` retry ladder
(the reference's ``handle_cuda_oom``): on an out-of-memory error, retry
with each fallback kwargs dict in turn (a smaller batch, ...).
``is_oom_error`` recognises ``torch.OutOfMemoryError`` and CUDA's "out of
memory" messages; ``device_memory_stats`` reads the caching allocator's
byte counters.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import torch


def is_oom_error(exc: BaseException) -> bool:
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = str(exc).lower()
    return "out of memory" in msg or "cudaerrormemoryallocation" in msg


def handle_cuda_oom(func: Callable, *args, alternatives: Iterable[Dict[str, Any]] = (), **kwargs):
    """``func(*args, **kwargs)``; on an out-of-memory error, the cache is
    emptied and the call retried with each ``alternatives`` dict merged
    into the kwargs. The last OOM is raised when every attempt fails; any
    other error at once."""
    attempts = [dict(kwargs)] + [dict(kwargs, **alt) for alt in alternatives]
    last: Optional[BaseException] = None
    for attempt in attempts:
        try:
            return func(*args, **attempt)
        except Exception as exc:  # noqa: BLE001 - filtered below
            if not is_oom_error(exc):
                raise
            last = exc
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    raise last  # type: ignore[misc]


def device_memory_stats(device=None) -> Dict[str, int]:
    """The caching allocator's byte counters of a CUDA device
    (``torch.cuda.memory_stats``); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: int(v) for k, v in stats.items() if "bytes" in k and isinstance(v, (int, float))}
