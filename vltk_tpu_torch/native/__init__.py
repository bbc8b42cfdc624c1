"""Native (C++) host code of the port: the WordPiece tokenizer
(``src/wordpiece.cpp``) and the mask decoders (``src/maskops.cpp``: COCO
RLE, CLEVR-ref point runs, polygon scanline fill), copies of the JAX
package's sources.

Both sources are compiled together with ``g++`` on first use into one
library in ``native/_build/`` (git-ignored), named by the hash of the
sources, and bound with ctypes. Nothing is built when the module is
imported; a failed build raises with the compiler's output. There is no
quiet fallback: the NumPy/PIL mask functions of ``utils/adapters.py`` are
the plain versions the tests hold the native ones against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_SOURCES = ("wordpiece.cpp", "maskops.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _source_hash() -> str:
    digest = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def _build() -> str:
    so_path = os.path.join(_BUILD_DIR, f"libvltk_native_{_source_hash()}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # per-process tmp name and an atomic replace: concurrent first builds
    # (loader threads, spawned ETL workers) each load a complete library
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           *(os.path.join(_SRC_DIR, s) for s in _SOURCES), "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on native/src/{{{','.join(_SOURCES)}}}:\n{res.stderr}")
    os.replace(tmp, so_path)
    return so_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i32p, i64p = c.POINTER(c.c_int32), c.POINTER(c.c_int64)
    u8p, f64p = c.POINTER(c.c_uint8), c.POINTER(c.c_double)
    ccharpp = c.POINTER(c.c_char_p)
    lib.vltk_wp_new.restype = c.c_void_p
    lib.vltk_wp_new.argtypes = [c.c_char_p, c.c_int]
    lib.vltk_wp_free.restype = None
    lib.vltk_wp_free.argtypes = [c.c_void_p]
    lib.vltk_wp_vocab_size.restype = c.c_int32
    lib.vltk_wp_vocab_size.argtypes = [c.c_void_p]
    lib.vltk_wp_token_id.restype = c.c_int32
    lib.vltk_wp_token_id.argtypes = [c.c_void_p, c.c_char_p]
    lib.vltk_wp_encode_batch.restype = None
    lib.vltk_wp_encode_batch.argtypes = [
        c.c_void_p, ccharpp, c.c_int64, c.c_int32, c.c_int, i32p, i32p, i32p, c.c_int32,
    ]
    lib.vltk_wp_encode_words.restype = c.c_int64
    lib.vltk_wp_encode_words.argtypes = [c.c_void_p, ccharpp, c.c_int64, i32p, c.c_int64, i32p]
    lib.vltk_rle_decode.restype = None
    lib.vltk_rle_decode.argtypes = [i64p, c.c_int64, u8p, c.c_int64, c.c_int64]
    lib.vltk_points_decode.restype = None
    lib.vltk_points_decode.argtypes = [i64p, c.c_int64, u8p, c.c_int64]
    lib.vltk_polygons_fill.restype = None
    lib.vltk_polygons_fill.argtypes = [f64p, i64p, c.c_int64, u8p, c.c_int64, c.c_int64]
    return lib


def lib() -> ctypes.CDLL:
    """The loaded native library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(_build()))
        return _lib
