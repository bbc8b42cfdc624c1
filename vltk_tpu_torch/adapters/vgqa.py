"""Visual Genome QA: counterpart of ``vltk_tpu/adapters/vgqa.py``, a
vision-language dataset over Visual Genome's images."""

from __future__ import annotations

from collections import Counter

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visnlang import VisnLangDataset
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.utils.adapters import clean_label


class VGQA(VisnLangDataset):
    """Groups of ``qas`` -> image id, question, qa id and the cleaned
    answer as the label; answers seen fewer than ``min_label_frequency``
    times drop their question."""

    data_info = {
        "train": {"visualgenome": ["train"]},
    }

    @staticmethod
    def schema():
        return {V.qid: Features.String(), V.label: Features.StringList()}

    @staticmethod
    def forward(text_data, split, min_label_frequency: int = 9):
        label_frequencies: Counter = Counter()
        qa_items = []
        for _fname, data in text_data.items():
            for group in data:
                for qa in group.get("qas", []):
                    label_frequencies[clean_label(qa.get("answer", ""))] += 1
                    qa_items.append(qa)

        entries = []
        skipped = 0
        for qa in qa_items:
            answer = clean_label(qa.get("answer", ""))
            if label_frequencies[answer] < min_label_frequency:
                skipped += 1
                continue
            entries.append({
                V.imgid: str(qa["image_id"]),
                V.text: qa["question"],
                V.qid: str(qa["qa_id"]),
                V.label: [answer],
            })
        if skipped:
            print(f"VGQA: skipped {skipped} rare-answer questions")
        return entries
