"""VisnDataset: the adapter of vision annotation datasets.

Counterpart of ``vltk_tpu/adapters/visn.py``. Subclasses declare
``schema()`` and ``forward(json_files, splits)``; ``extract()`` globs the
annotation JSONs, runs ``forward`` and writes one ``annotations.arrow``.
``files()`` / ``load_imgid2path()`` map image ids to the image files under
``{datadir}/{name}[/{split}]``.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.base import Adapter
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.inspection import collect_args_to_func
from vltk_tpu_torch.utils.base import try_load

_IMG_EXTS = (".jpg", ".jpeg", ".png")


class VisnDataset(Adapter):
    _base_features: Dict[str, Any] = {V.imgid: Features.Imgid()}

    @classmethod
    def adjust_imgid(cls, imgid: str) -> str:
        """Raw id -> canonical id."""
        return str(imgid)

    @classmethod
    def files(cls, datadir: str, split: Optional[str] = None) -> List[str]:
        """Every image file under {datadir}/{name}[/{split}], sorted."""
        base = os.path.join(datadir, cls.name())
        pattern = os.path.join(base, split, "**") if split else os.path.join(base, "**")
        return sorted(p for p in glob.glob(pattern, recursive=True) if p.lower().endswith(_IMG_EXTS))

    @classmethod
    def load_imgid2path(cls, datadir: str, split: Optional[str] = None) -> Dict[str, str]:
        return {
            cls.adjust_imgid(os.path.splitext(os.path.basename(path))[0]): path
            for path in cls.files(datadir, split)
        }

    @classmethod
    def extract(cls, datadir: str, annotation_dir: Optional[str] = None, splits: Optional[Sequence[str]] = None,
                **kwargs) -> Adapter:
        """Annotation JSONs -> ``forward`` -> ``{datadir}/{name}/annotations.arrow``."""
        base = os.path.join(datadir, cls.name())
        ann_dir = annotation_dir or os.path.join(base, V.ANNOTATION_DIR)
        search = ann_dir if os.path.isdir(ann_dir) else base
        json_files: Dict[str, Any] = {}
        for path in sorted(glob.glob(os.path.join(search, "**"), recursive=True)):
            if not path.endswith((".json", ".jsonl")):
                continue
            if any(f.lower() in os.path.basename(path).lower() for f in cls.filters):
                continue
            data = try_load(path)
            if data is not None:
                # keyed by the path under the annotation directory: files of
                # one name in per-split directories must not overwrite
                json_files[os.path.relpath(path, search)] = data
        if not json_files:
            raise FileNotFoundError(f"no annotation json files for {cls.name()} under {search}")
        schema = cls.full_schema(**kwargs)
        entries = cls.forward(json_files, splits=splits, **collect_args_to_func(cls.forward, kwargs))
        return cls._write_entries(_normalize_entries(entries, cls.adjust_imgid), schema,
                                  os.path.join(base, "annotations.arrow"))

    @classmethod
    def forward(cls, json_files: Iterable, splits: Optional[Sequence[str]] = None, **kwargs):  # pragma: no cover
        raise NotImplementedError


def _normalize_entries(entries, adjust):
    for entry in entries:
        if entry is None:
            continue
        if V.imgid in entry:
            entry[V.imgid] = adjust(str(entry[V.imgid]))
        yield entry
