"""Vision side of an entry: counterpart of ``vltk_tpu/data/visndataset.py``.

Per image id, the first vision source that has it: the extractor's table
(precomputed FRCNN features, fixed shape), the image file through the host
pipeline (a fixed canvas), or ``rand_feats`` (random features from numpy's
global generator, as the JAX package draws them). Annotation rows (gt boxes
padded with a mask; label strings mapped to ids) are merged, and the
vision copies of text keys renamed (``VLOVERLAP``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.data.basedataset import CollatedSets
from vltk_tpu_torch.utils.adapters import pad_tensor


class VisnHandler:
    def __init__(
        self,
        data_config,
        imgid2path: Optional[Mapping[str, str]] = None,
        extractor_sets: Optional[CollatedSets] = None,
        annotation_sets: Optional[CollatedSets] = None,
        metadata_ids: Optional[Mapping[str, Mapping[str, int]]] = None,
        visn_processors: Sequence[Callable] = (),
    ):
        self.config = data_config
        self.imgid2path = dict(imgid2path or {})
        self.extractors = extractor_sets
        self.annotations = annotation_sets
        self.metadata_ids = dict(metadata_ids or {})
        self.visn_processors = list(visn_processors)
        self._image_pipeline = None
        if not data_config.ignore_image and data_config.rand_feats is None:
            self._image_pipeline = data_config.vision.build()

    def get_entry(self, imgid: str) -> Dict[str, Any]:
        entry: Dict[str, Any] = {V.imgid: imgid}
        cfg = self.config
        if self.extractors is not None and self.extractors.has(imgid):
            self._attach_features(entry, self.extractors.get(imgid))
        elif cfg.rand_feats is not None:
            shape = tuple(cfg.rand_feats)
            entry[V.features] = np.random.rand(*shape).astype(np.float32)
            entry[V.boxes] = np.zeros((shape[0], 4), np.float32)
            entry[V.boxes_mask] = np.ones((shape[0],), np.int32)
        elif not cfg.ignore_image:
            path = self.imgid2path.get(imgid)
            if path is not None:
                self._attach_image(entry, path)
            elif not cfg.ignore_filepath:
                raise KeyError(f"no image file for imgid {imgid!r}")
        if self.annotations is not None and not cfg.ignore_annotations and self.annotations.has(imgid):
            self._attach_annotations(entry, self.annotations.get(imgid))
        # processors see the raw annotation values; ids and renames after
        for proc in self.visn_processors:
            entry = proc(entry)
        self._finalize_annotations(entry)
        return entry

    def _attach_features(self, entry: Dict[str, Any], row: Mapping[str, Any]) -> None:
        d = int(self.config.max_detections)
        feats = np.asarray(row[V.features], np.float32)
        entry[V.features] = pad_tensor(feats, d)
        if row.get(V.boxes) is not None:
            entry[V.boxes] = pad_tensor(np.asarray(row[V.boxes], np.float32), d)
        if row.get(V.rawsize) is not None:
            # the raw (h, w) the extraction wrote: the boxes' extent
            entry[V.rawsize] = np.asarray(row[V.rawsize], np.float32)
        mask = np.zeros((d,), np.int32)
        mask[: min(feats.shape[0], d)] = 1
        entry[V.boxes_mask] = mask
        for k in ("object_ids", "attr_ids"):
            if row.get(k) is not None:
                entry[k] = pad_tensor(np.asarray(row[k], np.int32), d, value=-1)

    def _attach_image(self, entry: Dict[str, Any], path: str) -> None:
        processed = self._image_pipeline({V.filepath: path})
        entry[V.img] = np.asarray(processed[V.img], np.float32)
        for k in (V.size, V.rawsize, V.scale, V.padsize):
            if k in processed:
                entry[k] = np.asarray(processed[k], np.float32)
        entry[V.filepath] = path

    def _attach_annotations(self, entry: Dict[str, Any], row: Mapping[str, Any]) -> None:
        """Annotation row -> entry, raw under the row's keys (gt boxes padded
        to the detection capacity with a mask)."""
        cfg = self.config
        d = int(cfg.max_detections)
        for key, value in row.items():
            if key.startswith("__") or key == V.imgid or value is None:
                continue
            if key in (V.segmentations, V.polygons, V.RLE) and cfg.ignore_segmentation:
                continue
            if key == V.boxes:
                boxes = np.asarray(value, np.float32).reshape(-1, 4)[:d]
                entry["gt_" + V.boxes] = pad_tensor(boxes, d)
                mask = np.zeros((d,), np.int32)
                mask[: boxes.shape[0]] = 1
                entry["gt_" + V.boxes_mask] = mask
            else:
                entry[key] = value

    def _label_table(self, key: str) -> Mapping[str, int]:
        """The id table of a string column (a singular column uses its
        plural's); a column without one maps every string to -1."""
        return self.metadata_ids.get(key) or self.metadata_ids.get(key + "s") or {}

    def _finalize_annotations(self, entry: Dict[str, Any]) -> None:
        """Leftover strings -> ids (lists padded with -1), VLOVERLAP renames."""
        d = int(self.config.max_detections)
        for key in list(entry.keys()):
            value = entry[key]
            if key in (V.imgid, V.filepath, "__dataset__", "__split__"):
                continue
            out_key = V.VLOVERLAP.get(key, key)
            if isinstance(value, (list, tuple)) and value and isinstance(value[0], str):
                table = self._label_table(key)
                ids = [int(table.get(s, -1)) for s in value][:d]
                entry.pop(key)
                entry[out_key] = pad_tensor(np.asarray(ids, np.int32), d, value=-1)
            elif isinstance(value, str):
                table = self._label_table(key)
                entry.pop(key)
                entry[out_key] = np.int32(table.get(value, -1))
            elif out_key != key:
                entry[out_key] = entry.pop(key)
