"""VQA v2 questions and annotations: counterpart of
``vltk_tpu/adapters/vqa.py``."""

from __future__ import annotations

from collections import Counter

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visnlang import VisnLangDataset
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.utils.adapters import clean_label, soft_score


class VQA(VisnLangDataset):
    """questions + annotations JSON -> qid, text, answers and their soft
    scores; answers seen ``min_label_frequency`` times or fewer are dropped,
    and a question left with none is skipped."""

    data_info = {
        "val": {"coco2014": ["val"]},
        "train": {"coco2014": ["train"]},
        "test": {"coco2014": ["test"]},
    }

    @staticmethod
    def schema():
        return {V.qid: Features.String(), V.label: Features.StringList(), V.score: Features.FloatList()}

    @staticmethod
    def adjust_imgid(imgid: str, vdset_name: str = "", vdset_split: str = "") -> str:
        """A numeric id -> COCO_{split}2014_000000xxxxxx."""
        prefix = (vdset_split or "val").lower()
        return f"COCO_{prefix}2014_{str(imgid).zfill(12)}"

    @staticmethod
    def forward(text_data, split, min_label_frequency: int = 9):
        questions = []
        qid2answers = {}
        label_frequencies: Counter = Counter()
        for _fname, payload in text_data.items():
            if "questions" in payload:
                questions.extend(payload["questions"])
            elif "annotations" in payload:
                annotations = payload["annotations"]
                accepted = {clean_label(a["multiple_choice_answer"]) for a in annotations}
                for anno in annotations:
                    label_frequencies[clean_label(anno["multiple_choice_answer"])] += 1
                    counts: Counter = Counter()
                    for ans_dict in anno.get("answers", []):
                        ans = clean_label(ans_dict["answer"])
                        if ans in accepted:
                            counts[ans] += 1
                    qid2answers[str(anno["question_id"])] = {k: soft_score(v) for k, v in counts.items()}

        entries = []
        skipped = 0
        for q in questions:
            entry = {V.imgid: str(q["image_id"]), V.text: q["question"], V.qid: str(q["question_id"])}
            answers = qid2answers.get(entry[V.qid])
            if answers is not None:
                kept = {lab: s for lab, s in answers.items() if label_frequencies[lab] > min_label_frequency}
                if not kept:
                    skipped += 1
                    continue
                entry[V.label], entry[V.score] = VisnLangDataset._label_handler(kept)
            entries.append(entry)
        if skipped:
            print(f"VQA: skipped {skipped} rare-answer questions")
        return entries
