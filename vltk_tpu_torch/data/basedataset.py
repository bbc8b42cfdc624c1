"""Index algebra over several adapters: counterpart of
``vltk_tpu/data/basedataset.py``. Adapters of several datasets and splits
concatenate into one global row index, and a lookup by image id falls
back across them. Host bookkeeping only."""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Sequence, Tuple


class SplitRanges:
    """Global row -> (dataset name, split, adapter, local row)."""

    def __init__(self, parts: Sequence[Tuple[str, str, Any]]):
        self.parts = list(parts)
        self._starts: List[int] = []
        total = 0
        for _, _, adapter in self.parts:
            self._starts.append(total)
            total += len(adapter)
        self._total = total

    def __len__(self) -> int:
        return self._total

    def locate(self, idx: int) -> Tuple[str, str, Any, int]:
        if idx < 0 or idx >= self._total:
            raise IndexError(idx)
        part = bisect.bisect_right(self._starts, idx) - 1
        name, split, adapter = self.parts[part]
        return name, split, adapter, idx - self._starts[part]

    def keys(self) -> List[Tuple[str, str]]:
        return [(n, s) for n, s, _ in self.parts]


class CollatedSets:
    """Concatenated adapters; ``get(img_id)`` asks each in turn."""

    def __init__(self, parts: Sequence[Tuple[str, str, Any]]):
        self.ranges = SplitRanges(parts)

    def __len__(self) -> int:
        return len(self.ranges)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        name, split, adapter, local = self.ranges.locate(idx)
        entry = adapter.get_idx(local)
        entry["__dataset__"] = name
        entry["__split__"] = split
        return entry

    def get(self, img_id: str) -> Dict[str, Any]:
        for name, split, adapter in self.ranges.parts:
            if adapter.has(img_id):
                entry = adapter.get(img_id)
                entry["__dataset__"] = name
                entry["__split__"] = split
                return entry
        raise KeyError(img_id)

    def has(self, img_id: str) -> bool:
        return any(a.has(img_id) for _, _, a in self.ranges.parts)

    @property
    def imgids(self) -> List[str]:
        seen: Dict[str, None] = {}
        for _, _, adapter in self.ranges.parts:
            for i in adapter.imgids:
                seen.setdefault(i)
        return list(seen)

    @property
    def adapters(self) -> List[Any]:
        return [a for _, _, a in self.ranges.parts]
