"""Visual Genome as an image source: counterpart of
``vltk_tpu/adapters/visualgenome.py``. GQA's and VGQA's ``data_info`` name
it, so their image ids resolve to ``{datadir}/visualgenome/{split}/{id}.jpg``
(``files`` / ``load_imgid2path``); it has no annotation columns."""

from __future__ import annotations

from vltk_tpu_torch.adapters.visn import VisnDataset


class VisualGenome(VisnDataset):
    @staticmethod
    def schema():
        return {}

    @staticmethod
    def forward(json_files, splits=None):
        return []
