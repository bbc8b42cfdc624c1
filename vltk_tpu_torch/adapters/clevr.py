"""CLEVR scenes: counterpart of ``vltk_tpu/adapters/clevr.py``."""

from __future__ import annotations

import numpy as np

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visn import VisnDataset
from vltk_tpu_torch.features import Features


class CLEVR(VisnDataset):
    """Scenes JSON -> one row an image: the objects' pixel coordinates
    (n, dim) and their colours, shapes, sizes and materials."""

    @staticmethod
    def schema(dim: int = 3):
        return {
            "positions": Features.Features2D(d=dim),
            "colors": Features.StringList(),
            "shapes": Features.StringList(),
            "sizes": Features.StringList(),
            "materials": Features.StringList(),
        }

    @staticmethod
    def forward(json_files, splits=None):
        entries = {}
        for _fname, js in json_files.items():
            for scene in js.get("scenes", []):
                imgid = scene["image_filename"].split(".")[0]
                objs = scene.get("objects", [])
                entries[imgid] = {
                    V.imgid: imgid,
                    "positions": np.asarray([o["pixel_coords"] for o in objs], dtype=np.float32).reshape(
                        len(objs), -1),
                    "colors": [o["color"] for o in objs],
                    "shapes": [o["shape"] for o in objs],
                    "sizes": [o["size"] for o in objs],
                    "materials": [o["material"] for o in objs],
                }
        return list(entries.values())
