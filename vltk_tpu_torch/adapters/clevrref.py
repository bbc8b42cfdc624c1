"""CLEVR-Ref+ scenes with masks: counterpart of
``vltk_tpu/adapters/clevrref.py``."""

from __future__ import annotations

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.visn import VisnDataset
from vltk_tpu_torch.features import Features


class CLEVRREF(VisnDataset):
    """Scene files (a "scene" in the name) -> one row an image: each
    object's mask as (start, run) point pairs (``RLE``), its box and its
    colour, shape, size and material."""

    @staticmethod
    def schema():
        return {
            V.RLE: Features.RLE(),
            "colors": Features.StringList(),
            "shapes": Features.StringList(),
            "sizes": Features.StringList(),
            "materials": Features.StringList(),
            V.box: Features.Boxes(),
        }

    @staticmethod
    def forward(json_files, splits=None):
        entries = {}
        for fname, js in json_files.items():
            if "scene" not in fname:
                continue
            for scene in js.get("scenes", []):
                imgid = scene["image_filename"].split(".")[0]
                colors, shapes, materials, sizes, boxes, points = [], [], [], [], [], []
                obj_boxes = list(scene.get("obj_bbox", {}).values())
                obj_masks = list(scene.get("obj_mask", {}).values())
                for obj, bbox, seg in zip(scene.get("objects", []), obj_boxes, obj_masks):
                    boxes.append([float(b) for b in bbox])
                    colors.append(obj["color"])
                    shapes.append(obj["shape"])
                    materials.append(obj["material"])
                    sizes.append(obj["size"])
                    if isinstance(seg, str):
                        points.append([float(p) for p in seg.split(",")])
                entries[imgid] = {
                    V.imgid: imgid,
                    V.RLE: points,
                    "colors": colors,
                    "shapes": shapes,
                    "materials": materials,
                    "sizes": sizes,
                    V.box: boxes,
                }
        return list(entries.values())
