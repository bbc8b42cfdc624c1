"""COCO-2014 instance annotations: counterpart of
``vltk_tpu/adapters/coco2014.py``."""

from __future__ import annotations

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visn import VisnDataset
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.utils.adapters import basic_coco_annotations


class Coco2014(VisnDataset):
    """instances_*.json -> per-image boxes, polygons and object names."""

    @staticmethod
    def schema():
        return {V.boxes: Features.Boxes(), V.polygons: Features.Polygons(), V.labels: Features.StringList()}

    @staticmethod
    def forward(json_files, splits=None):
        return basic_coco_annotations(json_files)
