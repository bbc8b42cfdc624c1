"""The general traffic generator: inputs made from ``--seed`` and the
parameters of a traffic file.

Every seed gets the same multiset of sizes (a fixed grid or a stratified
set of lengths) in its own order, with its own pixels or token ids, so the
work of a run does not depend on the seed, only its content and order do.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one named use of a seed (``stream`` keeps the
    uses of one seed apart)."""
    return np.random.default_rng([int(seed), int(stream)])


def image_sizes(t: Dict, seed: int) -> np.ndarray:
    """(pool, 2) raw (h, w): a grid of ``heights`` x ``widths`` (each a
    [lo, hi] range cut into as many steps as the pool needs), permuted by
    the seed."""
    n = int(t["pool_images"])
    side = int(np.ceil(np.sqrt(n)))
    hs = np.linspace(*t["heights"], side).round().astype(np.int64)
    ws = np.linspace(*t["widths"], side).round().astype(np.int64)
    grid = np.array([(h, w) for h in hs for w in ws][:n], np.int32)
    return grid[rng(seed, 1).permutation(n)]


def images(t: Dict, seed: int) -> List[np.ndarray]:
    """The pool of RGB uint8 images, (h, w, 3) each."""
    sizes = image_sizes(t, seed)
    g = rng(seed, 2)
    return [g.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8) for h, w in sizes]


def lengths(t: Dict, seed: int, count: int) -> np.ndarray:
    """``count`` real lengths stratified over [lo, hi] (the same set for
    every seed), permuted by the seed."""
    lo, hi = t["lengths"]
    grid = np.floor(lo + (np.arange(count) + 0.5) / count * (hi - lo + 1)).astype(np.int64)
    return grid[rng(seed, 3).permutation(count)]


def documents(t: Dict, seed: int, vocab_size: int, num_labels: int) -> Dict[str, np.ndarray]:
    """The pool of pre-encoded documents, ``pool_batches`` x ``batch``
    rows padded to ``seq``: ids ([CLS] first, [SEP] last, words drawn from
    the vocabulary past its first 1000 rows, 0 on pad), 0-1000 xyxy boxes
    laid out in reading order (words of 1-3 sub-tokens, ``words_per_line``
    words a line, a word's sub-tokens in its line and column slot), a 0/1 mask, labels on real tokens
    and -100 on pad. Arrays are (pool_batches, batch, seq[, 4])."""
    nb, b, s = int(t["pool_batches"]), int(t["batch"]), int(t["seq"])
    n = nb * b
    real = lengths(t, seed, n)
    g = rng(seed, 4)
    ids = g.integers(1000, vocab_size, (n, s), dtype=np.int64)
    ids[:, 0] = t["cls_id"]
    pos = np.arange(s)[None, :]
    ids[pos == (real[:, None] - 1)] = t["sep_id"]
    mask = (pos < real[:, None]).astype(np.float32)
    ids[mask == 0] = 0
    # words of 1-3 sub-tokens on lines of words_per_line sub-tokens
    word = np.cumsum(g.integers(0, 3, (n, s)) == 0, axis=1)
    per_line = int(t["words_per_line"])
    line, col = word // per_line, word % per_line
    lines = max(int(line.max()) + 1, 1)
    x0 = (col * (1000 // per_line) + g.integers(0, 8, (n, s))).clip(0, 990)
    y0 = (line * (1000 // lines)).clip(0, 990)
    boxes = np.stack([x0, y0, np.minimum(x0 + 1000 // per_line - 8, 1000), np.minimum(y0 + 1000 // lines, 1000)], -1)
    boxes = np.where(mask[..., None] > 0, boxes, 0).astype(np.int64)
    labels = np.where(mask > 0, g.integers(0, num_labels, (n, s)), -100).astype(np.int64)
    shape = (nb, b, s)
    return {"ids": ids.reshape(shape), "boxes": boxes.reshape(*shape, 4), "mask": mask.reshape(shape),
            "labels": labels.reshape(shape), "lengths": real.reshape(nb, b)}
