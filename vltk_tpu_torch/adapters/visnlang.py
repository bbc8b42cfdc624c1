"""VisnLangDataset: the adapter of text-over-images datasets.

Counterpart of ``vltk_tpu/adapters/visnlang.py``. Subclasses declare
``schema()``, ``forward(text_data, split)`` and ``data_info``, the map from
each text split to the vision dataset and splits whose images it is about.
``extract()`` finds each split's JSONs (leaving out ``filters``), runs
``forward`` and writes ``{split}.arrow`` with ``img_to_row_map`` and the
answer counters in its metadata.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.base import Adapter
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.inspection import collect_args_to_func
from vltk_tpu_torch.utils.base import try_load


class VisnLangDataset(Adapter):
    _base_features: Dict[str, Any] = {V.imgid: Features.Imgid(), V.text: Features.String()}

    # {text split: {vision dataset name: [vision splits]}}
    data_info: Mapping[str, Mapping[str, Sequence[str]]] = {}

    @classmethod
    def adjust_imgid(cls, imgid: str, vdset_name: str = "", vdset_split: str = "") -> str:
        """Raw id -> the vision dataset's id."""
        return str(imgid)

    @staticmethod
    def _label_handler(label: Mapping[str, float]) -> Tuple[List[str], List[float]]:
        """{label: score} -> parallel (labels, scores), highest score first."""
        if not label:
            return [""], [0.0]
        labels, scores = zip(*sorted(label.items(), key=lambda kv: -kv[1]))
        return list(labels), [float(s) for s in scores]

    @classmethod
    def extract(cls, datadir: str, splits: Optional[Sequence[str]] = None, **kwargs) -> Dict[str, Adapter]:
        """Per split: its JSONs -> ``forward`` -> ``{datadir}/{name}/{split}.arrow``."""
        base = os.path.join(datadir, cls.name())
        kwargs.setdefault("datadir", datadir)
        if splits is None:
            splits = sorted(cls.data_info.keys()) or sorted(V.SPLITALIASES)
        out: Dict[str, Adapter] = {}
        for split in splits:
            text_data: Dict[str, Any] = {}
            for path in cls._locate_split_files(base, split):
                data = try_load(path)
                if data is not None:
                    text_data[os.path.relpath(path, base)] = data
            if not text_data:
                continue
            entries = list(cls.forward(text_data, split, **collect_args_to_func(cls.forward, kwargs)))
            entries = cls._adjust_entries(entries, split)
            schema = cls._drop_all_none_columns(cls.full_schema(**kwargs), entries)
            adapter = cls._write_entries(entries, schema, os.path.join(base, f"{split}.arrow"))
            adapter._split = split
            out[split] = adapter
        if not out:
            raise FileNotFoundError(
                f"no text json files found for {cls.name()} under {base} (splits tried: {list(splits)})"
            )
        return out

    @classmethod
    def _locate_split_files(cls, base: str, split: str) -> List[str]:
        """The JSONs of ``split``: the split is a token of the path under
        ``base``, bounded by non-letters ('train2014' is 'train', 'testdev'
        is not 'test'), and no ``filters`` entry names the file."""
        token = re.compile(r"(?<![a-z])" + re.escape(split.lower()) + r"(?![a-z])")
        found = []
        for path in sorted(glob.glob(os.path.join(base, "**"), recursive=True)):
            if not path.endswith((".json", ".jsonl")):
                continue
            rel = os.path.relpath(path, base).lower()
            if any(f.lower() in os.path.basename(rel) for f in cls.filters):
                continue
            if token.search(rel):
                found.append(path)
        return found

    @classmethod
    def _adjust_entries(cls, entries: List[Dict], split: str) -> List[Dict]:
        info = cls.data_info.get(split, {})
        vdset_name = next(iter(info), "")
        vdset_split = info.get(vdset_name, [""])[0] if info else ""
        for entry in entries:
            if V.imgid in entry:
                entry[V.imgid] = cls.adjust_imgid(str(entry[V.imgid]), vdset_name, vdset_split)
        return entries

    @classmethod
    def _drop_all_none_columns(cls, schema: Dict[str, Any], entries: List[Dict]) -> Dict[str, Any]:
        """The schema without the columns no entry fills."""
        if not entries:
            return schema
        keep = set(cls._base_features)
        for entry in entries:
            keep.update(k for k, v in entry.items() if v is not None)
            if keep >= set(schema):
                break
        return {k: v for k, v in schema.items() if k in keep}

    @property
    def answer_frequencies(self) -> Dict[str, int]:
        return getattr(self, "labels_frequencies", {}) or getattr(self, "label_frequencies", {})

    @classmethod
    def forward(cls, text_data: List, split: str, **kwargs):  # pragma: no cover
        raise NotImplementedError
