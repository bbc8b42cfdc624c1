"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` into a
shared library with a plain C interface, cached under
``vltk_tpu_torch/_build/`` by the hash of its source, the shared headers
(``csrc/*.cuh``) and flags, and loaded with ``ctypes``. Nothing is compiled when a module is imported; a build
error raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: registers, shared memory and spills of each kernel, which
# build() hands back to the caller
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source extra flags: the NMS IoU must round like the reference's
# float32 expression, so no multiply-add contraction there
EXTRA_FLAGS: Dict[str, List[str]] = {"nms": ["--fmad=false"]}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (default
    /usr/local/cuda, the toolkit's standard install)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str) -> List[str]:
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def _so_path(name: str) -> str:
    """The library's path, keyed by the source, the shared headers of
    ``csrc/`` and the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[subprocess.Popen, str, str]:
    so = _so_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *_flags(name), "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, so


def _finish(name: str, proc: subprocess.Popen, tmp: str, so: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent build sees old or new
    return out


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is not cached yet, one
    ``nvcc`` per source, all started together. Returns the compiler output
    of each source it compiled."""
    pending = [n for n in names if not os.path.exists(_so_path(n))]
    procs = [(n, *_start(n)) for n in pending]
    outputs, errors = {}, []
    for name, proc, tmp, so in procs:
        try:
            outputs[name] = _finish(name, proc, tmp, so)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_so_path(name))
            _loaded[name] = lib
        return lib


def _kernel_name(mangled: str) -> str:
    """The function's own name in an Itanium-mangled symbol: the last
    length-prefixed segment of a nested name (``_ZN...``) before its
    template arguments, the first of a plain one (``_Z``; the segments
    after it name parameter types); an unmangled name as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    nested = mangled.startswith("_ZN")
    i, name = (3 if nested else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        size = int(mangled[i:j])
        name, i = mangled[j:j + size], j + size
        if not nested:
            break
    return name


def ptxas_lines(out: str) -> List[str]:
    """The ``-Xptxas -v`` lines of a build's output that say what a kernel
    costs (registers, shared memory, stack and spills) or where ptxas gave
    up performance, each prefixed with its kernel's name."""
    lines, kernel = [], None
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            kernel = _kernel_name(line.split("'")[1] if "'" in line else line.split()[-1])
            continue
        text = line.replace("ptxas info    :", "").strip()
        if "Performance Loss" in line:
            lines.append(text)
        elif kernel and ("registers" in line or "spill" in line):
            lines.append(f"{kernel}: {text}")
    return lines


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
