"""Host image transforms: counterpart of ``vltk_tpu/processing/image.py``.

Numpy and PIL: file decode, shortest-edge resize with a clamp on the longer
side, caffe-style BGR mean normalisation and a pad onto a fixed canvas,
each recording what later stages need (``rawsize``, ``size``,
``wh_scale``, ``padsize``). ``Pad`` pads to one fixed canvas so every image
of a run has one shape.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from vltk_tpu_torch import vars as V


class FromFile:
    """filepath -> (h, w, 3) RGB array (gray replicated to 3 channels),
    float32 or, with ``decode_dtype="uint8"``, the decoded bytes as they
    are (for pipelines whose resize and normalise run on the device)."""

    def __init__(self, gray: bool = False, decode_dtype: str = "float32"):
        self.gray = gray
        self.dtype = np.uint8 if str(decode_dtype) == "uint8" else np.float32

    def __call__(self, entry):
        if isinstance(entry, str):
            entry = {V.filepath: entry}
        with Image.open(entry[V.filepath]) as img:
            arr = np.asarray(img.convert("L" if self.gray else "RGB"), dtype=self.dtype)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        entry[V.img] = arr
        entry[V.rawsize] = (arr.shape[0], arr.shape[1])
        return entry


class ToTensor:
    """float32 guard (the transform name of the reference pipeline)."""

    def __init__(self):  # takes no config field
        pass

    def __call__(self, entry):
        entry[V.img] = np.asarray(entry[V.img], dtype=np.float32)
        return entry


def shortest_edge_size(raw_h: int, raw_w: int, short: int, maximum: int) -> Tuple[int, int]:
    """Target (h, w) of a shortest-edge resize with a clamp on the longer
    side."""
    scale = short / min(raw_h, raw_w)
    if max(raw_h, raw_w) * scale > maximum:
        scale = maximum / max(raw_h, raw_w)
    return int(raw_h * scale + 0.5), int(raw_w * scale + 0.5)


class ResizeTensor:
    """Shortest-edge resize, recording rawsize, size and wh_scale."""

    def __init__(self, size: Sequence[int] = (800, 1333), mode: str = "bilinear"):
        self.short = int(size[0])
        self.maximum = int(size[1]) if len(size) > 1 else int(size[0])
        self.mode = mode

    def __call__(self, entry):
        arr = entry[V.img]
        raw_h, raw_w = arr.shape[0], arr.shape[1]
        new_h, new_w = shortest_edge_size(raw_h, raw_w, self.short, self.maximum)
        if (new_h, new_w) != (raw_h, raw_w):
            resample = Image.BILINEAR if self.mode == "bilinear" else Image.NEAREST
            if arr.dtype == np.uint8 or (arr.dtype == np.float32 and arr.min() >= 0 and arr.max() <= 255):
                # whole-pixel range: one 3-channel uint8 resize
                arr = np.asarray(
                    Image.fromarray(arr.astype(np.uint8)).resize((new_w, new_h), resample=resample), dtype=np.float32
                )
            else:
                # other floats (negatives after a normalise): one mode-"F"
                # resize a channel; a uint8 cast would wrap them
                arr = np.stack(
                    [
                        np.asarray(Image.fromarray(arr[..., c].astype(np.float32), mode="F")
                                   .resize((new_w, new_h), resample=resample))
                        for c in range(arr.shape[-1])
                    ],
                    axis=-1,
                ).astype(np.float32)
        entry[V.img] = arr
        entry[V.rawsize] = (raw_h, raw_w)
        entry[V.size] = (new_h, new_w)
        # (w_scale, h_scale): raw coordinates times this land in the resize
        entry[V.scale] = (new_w / raw_w, new_h / raw_h)
        return entry


class Normalize:
    """Channel mean / std normalisation after an optional RGB -> BGR swap."""

    def __init__(self, mean: Sequence[float] = (102.9801, 115.9465, 122.7717),
                 sdev: Sequence[float] = (1.0, 1.0, 1.0), bgr: bool = True):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.sdev = np.asarray(sdev, dtype=np.float32)
        self.bgr = bgr

    def __call__(self, entry):
        arr = entry[V.img]
        if self.bgr:
            arr = arr[..., ::-1]
        entry[V.img] = (arr - self.mean) / self.sdev
        return entry


class Pad:
    """Pad bottom / right onto a fixed canvas, recording padsize."""

    def __init__(self, canvas: Optional[Sequence[int]] = None, pad_value: float = 0.0):
        self.canvas = tuple(canvas) if canvas else None
        self.pad_value = float(pad_value)

    def __call__(self, entry):
        if self.canvas is None:
            return entry
        arr = entry[V.img]
        ch, cw = self.canvas
        h, w = arr.shape[0], arr.shape[1]
        if h > ch or w > cw:
            raise ValueError(f"image ({h},{w}) exceeds canvas {self.canvas}; resize first")
        out = np.full((ch, cw, arr.shape[-1]), self.pad_value, dtype=np.float32)
        out[:h, :w] = arr
        entry[V.img] = out
        entry[V.padsize] = (ch, cw)
        return entry


class GrayScale:
    """Channel mean, repeated to 3 channels."""

    def __init__(self):  # takes no config field
        pass

    def __call__(self, entry):
        gray = entry[V.img].mean(axis=-1, keepdims=True)
        entry[V.img] = np.repeat(gray, 3, axis=-1)
        return entry


class RandFeats:
    """Random image content of ``shape`` from a seeded numpy generator: the
    pipeline runs with no image files."""

    def __init__(self, shape: Sequence[int], seed: int = 0):
        self.shape = tuple(int(s) for s in shape)
        self.rng = np.random.default_rng(seed)

    def __call__(self, entry):
        if isinstance(entry, str):
            entry = {V.filepath: entry}
        entry[V.img] = self.rng.random(self.shape, dtype=np.float32)
        entry[V.rawsize] = self.shape[:2]
        entry[V.size] = self.shape[:2]
        entry[V.scale] = (1.0, 1.0)
        return entry


def canvas_for(size: Sequence[int], multiple: int = 32) -> Tuple[int, int]:
    """The square canvas covering any shortest-edge resize to ``size``: the
    longest side rounded up to ``multiple``."""
    side = int(math.ceil(max(int(s) for s in size) / multiple) * multiple)
    return side, side
