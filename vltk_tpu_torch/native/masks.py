"""ctypes wrappers over the native mask decoders (src/maskops.cpp).

Counterpart of ``vltk_tpu/native/masks.py``, with the same C ABI. Each
function returns a row-major (h, w) uint8 {0, 1} mask and raises when the
library cannot be built (the JAX wrappers return None then).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from vltk_tpu_torch import native


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rle_decode(counts: Sequence[int], height: int, width: int) -> np.ndarray:
    """Uncompressed COCO RLE (column-major runs, zeros first) -> mask."""
    c = np.ascontiguousarray(counts, np.int64)
    out = np.empty((height, width), np.uint8)
    native.lib().vltk_rle_decode(_ptr(c, ctypes.c_int64), c.size, _ptr(out, ctypes.c_uint8), height, width)
    return out


def points_decode(points: Sequence[float], height: int, width: int) -> np.ndarray:
    """CLEVR-ref (start, run) pairs over the flattened row-major mask."""
    p = np.ascontiguousarray(points, np.int64)
    out = np.empty(height * width, np.uint8)
    native.lib().vltk_points_decode(_ptr(p, ctypes.c_int64), p.size // 2, _ptr(out, ctypes.c_uint8), height * width)
    return out.reshape(height, width)


def polygons_fill(polygons: Sequence[Sequence[float]], height: int, width: int) -> np.ndarray:
    """Flat xy polygons -> the union of their scanline fills."""
    lib = native.lib()
    sizes = np.asarray([len(p) for p in polygons], np.int64)
    if sizes.size == 0:
        return np.zeros((height, width), np.uint8)
    flat = np.ascontiguousarray(np.concatenate([np.asarray(p, np.float64).ravel() for p in polygons]))
    out = np.empty((height, width), np.uint8)
    lib.vltk_polygons_fill(_ptr(flat, ctypes.c_double), _ptr(sizes, ctypes.c_int64), sizes.size,
                           _ptr(out, ctypes.c_uint8), height, width)
    return out
