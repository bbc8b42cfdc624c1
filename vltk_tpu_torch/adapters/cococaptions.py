"""COCO captions: counterpart of ``vltk_tpu/adapters/cococaptions.py``."""

from __future__ import annotations

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visnlang import VisnLangDataset


class COCOCaptions(VisnLangDataset):
    """``captions_*.json`` -> one row a caption: the image's file-name stem
    and the caption text (no labels)."""

    data_info = {
        "train": {"coco2014": ["train"]},
        "val": {"coco2014": ["val"]},
    }

    @staticmethod
    def schema():
        return {}

    @staticmethod
    def forward(text_data, split):
        entries = []
        for _fname, data in text_data.items():
            anns = data.get("annotations", [])
            if not anns or "caption" not in anns[0]:
                continue
            id2name = {img["id"]: img["file_name"] for img in data.get("images", [])}
            for item in anns:
                name = id2name.get(item["image_id"])
                if name is None:
                    continue
                entries.append({V.imgid: name.split(".")[0], V.text: item["caption"]})
        return entries
