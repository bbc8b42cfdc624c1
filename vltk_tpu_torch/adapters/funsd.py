"""FUNSD form-understanding OCR annotations: counterpart of
``vltk_tpu/adapters/funsd.py``."""

from __future__ import annotations

import os

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visn import VisnDataset
from vltk_tpu_torch.features import Features

_VALID_LABELS = ("question", "answer", "other")


class FUNSD(VisnDataset):
    """One row a form: its words, their boxes (xyxy -> xywh) and their
    entity's label (question, answer or other; any other label is other)."""

    urls = "https://guillaumejaume.github.io/FUNSD/dataset.zip"

    @staticmethod
    def schema():
        return {V.tokenbox: Features.Boxes(), V.text: Features.StringList(), V.label: Features.StringList()}

    @staticmethod
    def forward(json_files, splits=None):
        entries = []
        seen = set()
        for fname, data in json_files.items():
            imgid = os.path.basename(fname).split(".")[0]
            if imgid in seen:
                raise ValueError(f"duplicate FUNSD form id {imgid}")
            seen.add(imgid)
            texts, labels, boxes = [], [], []
            for item in data.get("form", []):
                label = item.get("label", "other")
                if label not in _VALID_LABELS:
                    label = "other"
                for word in item.get("words", []):
                    texts.append(word["text"])
                    x1, y1, x2, y2 = word["box"]
                    boxes.append([float(x1), float(y1), float(x2 - x1), float(y2 - y1)])
                    labels.append(label)
            entries.append({V.imgid: str(imgid), V.text: texts, V.tokenbox: boxes, V.label: labels})
        return entries
