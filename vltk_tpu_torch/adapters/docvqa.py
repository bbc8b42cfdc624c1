"""DocVQA, question answering over OCR'd documents: counterpart of
``vltk_tpu/adapters/docvqa.py``.

``DocVQAVisn`` reads the Azure OCR results (line boxes, word boxes, word
texts); ``DocVQA`` reads the questions and grounds each answer as a span of
the document's OCR words by Jaccard matching (``get_span_via_jaccard`` at
``JACCARD_THRESHOLD``); a question with no groundable answer is skipped.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visn import VisnDataset
from vltk_tpu_torch.adapters.visnlang import VisnLangDataset
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.utils.adapters import get_span_via_jaccard

JACCARD_THRESHOLD = 0.56


def format_8pt_box(box: Sequence[float]) -> List[float]:
    """Azure's 8-point polygon -> its (x, y, w, h) bounding box."""
    xs = [float(box[i]) for i in range(0, 8, 2)]
    ys = [float(box[i]) for i in range(1, 8, 2)]
    x1, x2 = min(xs), max(xs)
    y1, y2 = min(ys), max(ys)
    return [x1, y1, x2 - x1, y2 - y1]


class DocVQAVisn(VisnDataset):
    """One row a document whose OCR succeeded and found words: the first
    page's line boxes, word boxes and word texts."""

    @staticmethod
    def schema():
        return {V.box: Features.Boxes(), V.tokenbox: Features.Boxes(), V.text: Features.StringList()}

    @staticmethod
    def forward(json_files, splits=None):
        entries = []
        for fname, data in json_files.items():
            imgid = fname.split(".")[0].split("/")[-1]
            if data.get("status") != "Succeeded":
                continue
            pages = data.get("recognitionResults", [])
            if not pages:
                continue
            boxes, tokenboxes, texts = [], [], []
            for line in pages[0].get("lines", []):
                boxes.append(format_8pt_box(line["boundingBox"]))
                for word in line.get("words", []):
                    texts.append(word["text"])
                    tokenboxes.append(format_8pt_box(word["boundingBox"]))
            if not texts:
                continue
            entries.append({V.imgid: imgid, V.box: boxes, V.text: texts, V.tokenbox: tokenboxes})
        return entries


class DocVQA(VisnLangDataset):
    """Questions with their answer grounded to an inclusive span of the
    document's OCR words (read from ``{datadir}/docvqavisn/annotations``)."""

    data_info = {
        "val": {"docvqavisn": ["val"]},
        "train": {"docvqavisn": ["train"]},
    }

    @staticmethod
    def schema():
        return {"answer": Features.String(), V.qid: Features.String(), V.span: Features.IntList()}

    @staticmethod
    def forward(text_data, split, datadir=None):
        skipped = 0
        entries = []
        for _fname, payload in text_data.items():
            for item in payload.get("data", []):
                question = item["question"].lower().replace('"', "")
                imgid = item["image"].split(".")[0].split("/")[-1]
                answers = [a.lower() for a in item.get("answers", [])]
                if datadir is None:
                    continue
                anno_path = os.path.join(datadir, "docvqavisn", "annotations", f"{imgid}.json")
                if not os.path.exists(anno_path):
                    skipped += 1
                    continue
                with open(anno_path) as f:
                    page = json.load(f)["recognitionResults"][0]
                words = [w["text"].lower() for line in page.get("lines", []) for w in line.get("words", [])]
                if not words:
                    skipped += 1
                    continue
                best_span, best_sim = None, 0.0
                for ans in answers:
                    span, sim = get_span_via_jaccard(words, ans, threshold=JACCARD_THRESHOLD)
                    if span is not None and sim > best_sim:
                        best_span, best_sim = span, sim
                if best_span is None:
                    skipped += 1
                    continue
                start, end = best_span
                entries.append({
                    V.text: question,
                    V.imgid: imgid,
                    "answer": " ".join(words[start : end + 1]),
                    V.span: [int(start), int(end)],
                    V.qid: str(item.get("docId", imgid)),
                })
        if skipped:
            print(f"DocVQA: skipped {skipped} questions (no groundable answer)")
        return entries
