"""Helpers shared by the block-shape sweeps (``tools.sweep_flash_backward``,
``tools.bench_roipool``) and ``chip_smoke.py``: build a variant of a kernel
source, time a call on the card, name the card, and place a tensor off
the 16-byte boundary. Everything here but ``unaligned`` needs the card.
"""

from __future__ import annotations

import os
import subprocess

import torch

from vltk_tpu_torch.ops import _build

SWEEP_DIR = os.path.join(_build.BUILD_DIR, "sweep")


def compile_variant(src: str, name: str, defines, tag: str):
    """Starts nvcc on ``src`` (a path, relative to the working directory,
    or a bare name under ``csrc/``; a copy elsewhere finds the headers of
    ``csrc/`` through ``-I``) with the flags of
    ``csrc/<name>.cu`` and ``defines``, into ``_build/sweep/lib<name>_<tag>.so``.
    Returns (library path, running process); the process's output is what
    ``_build.ptxas_lines`` reads."""
    os.makedirs(SWEEP_DIR, exist_ok=True)
    so = os.path.join(SWEEP_DIR, f"lib{name}_{tag}.so")
    path = os.path.abspath(src) if os.path.dirname(src) else os.path.join(_build.CSRC, src)
    cmd = [_build.nvcc_path(), *_build._flags(name), "-I", _build.CSRC, *defines, "-o", so, path]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def queued_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls, queued while
    the card sleeps (~20 ms) so that the host's time per call stays out of
    the span."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` one element into its storage, so not on a 16-byte
    boundary: what RoIPool's scalar path takes."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:].copy_(x.reshape(-1))
    return flat[1:].view(x.shape)
