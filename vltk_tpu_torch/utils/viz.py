"""Detection drawing with PIL (no matplotlib): counterpart of
``vltk_tpu/utils/viz.py``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

_PALETTE = [
    (220, 38, 38), (16, 185, 129), (59, 130, 246), (245, 158, 11),
    (139, 92, 246), (236, 72, 153), (20, 184, 166), (234, 88, 12),
]


def _to_numpy(x):
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().float().numpy()
    return np.asarray(x)


def draw_boxes(
    image,
    boxes,
    labels: Optional[Sequence[str]] = None,
    scores: Optional[Sequence[float]] = None,
    mask=None,
    width: int = 2,
) -> Image.Image:
    """Draw xyxy boxes (with labels and scores) on an image: a PIL image,
    an (H, W, 3) array or tensor, or a path. Rows where ``mask`` is false
    (the FRCNN output's padded detections) are skipped."""
    if isinstance(image, str):
        img = Image.open(image).convert("RGB")
    elif isinstance(image, Image.Image):
        img = image.convert("RGB")
    else:
        arr = _to_numpy(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        img = Image.fromarray(arr)
    draw = ImageDraw.Draw(img)
    boxes = _to_numpy(boxes).astype(np.float32).reshape(-1, 4)
    keep = None if mask is None else _to_numpy(mask).reshape(-1)
    for i, box in enumerate(boxes):
        if keep is not None and not bool(keep[i]):
            continue
        color = _PALETTE[i % len(_PALETTE)]
        x1, y1, x2, y2 = [float(v) for v in box]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=width)
        text = str(labels[i]) if labels is not None and i < len(labels) else ""
        if scores is not None and i < len(scores):
            text = f"{text} {float(scores[i]):.2f}".strip()
        if text:
            draw.text((x1 + 2, max(y1 - 11, 0)), text, fill=color)
    return img


def save_detections(path: str, image, detections: dict, id_to_name: Optional[Sequence[str]] = None) -> str:
    """Draw one image's detections of the FRCNN output dict (``boxes``,
    ``obj_ids``, ``obj_probs``, ``mask``) and save it at ``path``."""
    labels = None
    if id_to_name is not None:
        labels = [
            id_to_name[int(i)] if 0 <= int(i) < len(id_to_name) else "?"
            for i in _to_numpy(detections["obj_ids"]).reshape(-1)
        ]
    scores = _to_numpy(detections["obj_probs"]).reshape(-1) if "obj_probs" in detections else None
    img = draw_boxes(image, detections["boxes"], labels=labels, scores=scores, mask=detections.get("mask"))
    img.save(path)
    return path
