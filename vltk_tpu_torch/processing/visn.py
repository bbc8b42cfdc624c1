"""Vision-side processors: segmentation masks, OCR tokens, boxes.

Counterpart of ``vltk_tpu/processing/visn.py``: polygons or CLEVR-ref
point runs -> stacked binary masks at the model size (``PolygonProcessor``,
``RLEProcessor``); OCR words -> flattened sub-token ids, tokenmap and
attention mask (``AuxTokenize``); word boxes -> sub-token boxes at the
resized image (``OCRBox``) or 0-1000 normalised (``OCRBoxFixed``); word
labels -> sub-token label ids (``TokenLabels``); xywh -> xyxy
(``XYWHtoXYXY``); ``RemoveBox``. All outputs are fixed-shape numpy arrays
padded to ``max_visual_seq_length``.
"""

from __future__ import annotations

from itertools import chain
from typing import List

import numpy as np

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.processing.processor import VisnProcessor
from vltk_tpu_torch.utils.adapters import (
    imagepoints_to_mask,
    rescale_box,
    resize_binary_mask,
    seg_to_mask,
    truncate_and_pad_list,
)


def _stack_masks(masks: List[np.ndarray], size, max_len: int) -> np.ndarray:
    """(n, h, w) uint8: the first ``max_len`` masks (one zero mask when
    there are none), padded with zero masks to ``max_len``."""
    masks = masks[:max_len]
    if not masks:
        masks = [np.zeros(tuple(int(s) for s in size), dtype=np.uint8)]
    stacked = np.stack(masks)
    pad = max_len - stacked.shape[0]
    if pad > 0:
        stacked = np.pad(stacked, ((0, pad), (0, 0), (0, 0)))
    return stacked


class PolygonProcessor(VisnProcessor):
    """Polygons (each instance a list of flat xy lists, at the raw size) ->
    binary masks resized to the model size, (max_visual_seq_length, h, w)."""

    keys = (V.polygons, V.size)

    def setup(self, max_visual_seq_length: int = 128):
        self.max_len = max_visual_seq_length

    def forward(self, entry, **kwargs):
        size = entry[V.size]
        rawsize = entry.get(V.rawsize, size)
        masks = [resize_binary_mask(seg_to_mask(p, *rawsize), size) for p in entry.pop(V.polygons)]
        entry[V.segmentation] = _stack_masks(masks, size, self.max_len)
        return entry


class RLEProcessor(VisnProcessor):
    """CLEVR-ref point-run masks (at the raw size) -> binary masks resized
    to the model size, (max_visual_seq_length, h, w)."""

    keys = (V.RLE, V.size)

    def setup(self, max_visual_seq_length: int = 128):
        self.max_len = max_visual_seq_length

    def forward(self, entry, **kwargs):
        segs = entry.pop(V.RLE)
        rawsize, size = entry[V.rawsize], entry[V.size]
        masks = [resize_binary_mask(imagepoints_to_mask(s, rawsize), size) for s in segs]
        entry[V.segmentation] = _stack_masks(masks, size, self.max_len)
        return entry


class AuxTokenize(VisnProcessor):
    """OCR word list -> flattened sub-token ids + tokenmap (#subtokens per
    word) + visual_attention_mask."""

    keys = (V.text,)

    def setup(
        self,
        tokenizer=None,
        max_visual_seq_length: int = 128,
        add_visual_cls: bool = False,
        ignore_id: int = -100,
    ):
        self.tokenizer = tokenizer
        self.max_len = max_visual_seq_length
        self.add_visual_cls = add_visual_cls
        self.ignore_id = ignore_id

    def forward(self, entry, **kwargs):
        text = entry.pop(V.text)
        if not isinstance(text, (list, tuple)):
            return entry
        if len(text) == 1 and isinstance(text[0], list):
            text = text[0]
        tok = self.tokenizer
        if self.add_visual_cls:
            text = [tok.cls_token] + list(text)
        pieces = tok.encode_words(list(map(str, text)))
        pieces = [p if p else [tok.unk_id] for p in pieces]
        tokenmap = [len(p) for p in pieces]
        if len(tokenmap) >= self.max_len:
            tokenmap = tokenmap[: self.max_len - 1]
        entry[V.tokenmap] = np.asarray(
            truncate_and_pad_list(tokenmap, self.max_len, self.ignore_id), dtype=np.int32
        )
        flat = list(chain(*pieces))
        n_valid = min(self.max_len, len(flat))
        entry[V.visual_attention_mask] = np.asarray(
            [1] * n_valid + [0] * (self.max_len - n_valid), dtype=np.int32
        )
        flat = truncate_and_pad_list(flat, self.max_len - 1, tok.pad_id)
        flat = flat + [tok.sep_id]
        entry[V.text] = np.asarray(flat, dtype=np.int32)
        return entry


def _expand_by_tokenmap(items: List, tokenmap) -> List:
    """Repeat each word-level item by its sub-token count."""
    out: List = []
    for item, n in zip(items, tokenmap):
        n = int(n)
        if n <= 0:
            continue
        out.extend([item] * n)
    return out


class OCRBox(VisnProcessor):
    """Word boxes repeated per sub-token and, when the entry has its size
    and scale, rescaled to the resized image."""

    keys = (V.tokenbox,)

    def setup(self, max_visual_seq_length: int = 128, add_visual_cls: bool = False):
        self.max_len = max_visual_seq_length
        self.add_visual_cls = add_visual_cls

    def forward(self, entry, **kwargs):
        boxes = [list(map(float, b)) for b in entry.pop(V.tokenbox)]
        if self.add_visual_cls:
            rh, rw = entry.get(V.rawsize, (0, 0))
            boxes = [[0.0, 0.0, float(rw), float(rh)]] + boxes
        if V.tokenmap in entry:
            boxes = _expand_by_tokenmap(boxes, entry[V.tokenmap])
        boxes = truncate_and_pad_list(boxes, self.max_len, [0.0, 0.0, 0.0, 0.0])
        arr = np.asarray(boxes, dtype=np.float32)
        if V.size in entry and V.scale in entry:
            arr = rescale_box(arr, entry[V.scale])
        entry[V.tokenbox] = arr
        return entry


class OCRBoxFixed(VisnProcessor):
    """LayoutLM-style 0-1000 normalised token boxes."""

    keys = (V.tokenbox,)

    def setup(self, max_visual_seq_length: int = 128, add_visual_cls: bool = False):
        self.max_len = max_visual_seq_length
        self.add_visual_cls = add_visual_cls

    def forward(self, entry, **kwargs):
        boxes = [list(map(float, b)) for b in entry.pop(V.tokenbox)]
        rawsize = entry.get(V.rawsize, entry.get(V.size, (1000, 1000)))
        raw_h, raw_w = float(rawsize[0]), float(rawsize[1])
        if self.add_visual_cls:
            boxes = [[0.0, 0.0, raw_w, raw_h]] + boxes
        if V.tokenmap in entry:
            boxes = _expand_by_tokenmap(boxes, entry[V.tokenmap])
        boxes = truncate_and_pad_list(boxes, self.max_len, [0.0, 0.0, 0.0, 0.0])
        arr = np.asarray(boxes, dtype=np.float32)
        arr = rescale_box(arr, (1000.0 / raw_w, 1000.0 / raw_h))
        entry[V.tokenbox] = np.clip(arr, 0.0, 1000.0)
        return entry


class TokenLabels(VisnProcessor):
    """Word labels expanded to fixed-length sub-token label ids. Reads the
    word-level label strings (``tokenlabels`` if a prior processor produced
    them, else the adapter's ``label`` column), repeats each by its
    ``tokenmap`` count, maps them to ids through the label table of
    ``metadata_ids`` (``label`` or ``labels``), and pads with
    ``ignore_id``."""

    keys = (V.tokenmap,)

    def setup(
        self,
        max_visual_seq_length: int = 128,
        add_visual_cls: bool = False,
        metadata_ids=None,
        ignore_id: int = -100,
    ):
        self.max_len = max_visual_seq_length
        self.add_visual_cls = add_visual_cls
        self.metadata_ids = metadata_ids or {}
        self.ignore_id = ignore_id

    def forward(self, entry, **kwargs):
        labels = entry.pop(V.tokenlabels, None)
        if labels is None:
            labels = entry.pop(V.label, None)
        if labels is None:
            return entry
        labels = list(labels)
        if self.add_visual_cls:
            labels = [None] + labels
        labels = _expand_by_tokenmap(labels, entry[V.tokenmap])
        table = self.metadata_ids.get(V.label) or self.metadata_ids.get(V.labels, {})
        ids = [
            self.ignore_id if lab is None else int(table.get(lab, self.ignore_id))
            for lab in labels
        ][: self.max_len - 1]
        entry[V.tokenlabels] = np.asarray(
            truncate_and_pad_list(ids, self.max_len, self.ignore_id), dtype=np.int32
        )
        return entry


class XYWHtoXYXY(VisnProcessor):
    """(x, y, w, h) -> (x1, y1, x2, y2) on the tokenbox, box and boxes
    columns, as float32."""

    def forward(self, entry, **kwargs):
        for key in (V.tokenbox, V.box, V.boxes):
            if key in entry:
                arr = np.asarray(entry[key], dtype=np.float32)
                if arr.size:
                    arr = arr.copy()
                    arr[..., 2] += arr[..., 0]
                    arr[..., 3] += arr[..., 1]
                entry[key] = arr
        return entry


class RemoveBox(VisnProcessor):
    """Drop the box column."""

    def forward(self, entry, **kwargs):
        entry.pop(V.box, None)
        return entry
