"""Native (C++) host code of the port: the WordPiece tokenizer.

``src/wordpiece.cpp`` is compiled with ``g++`` on first use into
``native/_build/`` (git-ignored), named by the hash of the source, and
bound with ctypes. Nothing is built when the module is imported; a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "src", "wordpiece.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libvltk_wordpiece_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # per-process tmp name and an atomic replace: concurrent first builds
    # each load a complete library
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on native/src/wordpiece.cpp:\n{res.stderr}")
    os.replace(tmp, so_path)
    return so_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i32p = c.POINTER(c.c_int32)
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
    return lib


def lib() -> ctypes.CDLL:
    """The loaded WordPiece library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(_build()))
        return _lib
