"""GQA balanced question splits: counterpart of
``vltk_tpu/adapters/gqa.py``."""

from __future__ import annotations

from collections import Counter

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visnlang import VisnLangDataset
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.utils.adapters import clean_label


class GQA(VisnLangDataset):
    """``{split}_balanced_questions.json`` -> question, image id (without
    its "n"), the cleaned answer as the label and the semantic program's
    operations as ``layout``. Answers seen fewer than
    ``min_label_frequency`` times drop their question; the test split has
    no labels."""

    data_info = {
        "dev": {"coco2014": ["test"]},
        "train": {"visualgenome": ["train"]},
        "val": {"visualgenome": ["train"]},
        "test": {"coco2014": ["test"]},
        "testdev": {"coco2014": ["val"]},
    }

    # the unbalanced dumps and the all-train shards are not read
    filters = ("unbalanced", "train_all")

    @staticmethod
    def schema():
        return {V.label: Features.StringList(), "layout": Features.StringList()}

    @staticmethod
    def forward(text_data, split, min_label_frequency: int = 2):
        label_frequencies: Counter = Counter()
        for _fname, data in text_data.items():
            for v in data.values():
                if "answer" in v:
                    label_frequencies[clean_label(v["answer"])] += 1

        entries = []
        skipped = 0
        for _fname, data in text_data.items():
            for v in data.values():
                if split == "test":
                    answer, layout = None, None
                else:
                    answer = clean_label(v.get("answer", ""))
                    if label_frequencies[answer] < min_label_frequency:
                        skipped += 1
                        continue
                    layout = [op["operation"] for op in v.get("semantic", [])]
                entries.append({
                    V.text: v["question"],
                    V.imgid: str(v["imageId"]).lstrip("n"),
                    V.label: [answer] if answer is not None else None,
                    "layout": layout,
                })
        if skipped:
            print(f"GQA: skipped {skipped} rare-answer questions")
        return entries
