"""Language-side label sampling and LXMERT's pretraining corruptions:
soft-score label sampling, masked language modeling (80/10/10) and
region-feature masking.

Copies of ``one_hot_label``, ``masked_language_modeling`` and
``masked_feature_modeling`` from ``vltk_tpu/processing/lang.py``: host
numpy that draws from an explicit
``np.random.Generator`` in the same order as the JAX package's, so the same
generator state gives the same corruption bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def one_hot_label(labels: Sequence[int], scores: Sequence[float], rng: np.random.Generator,
                  ignore_id: int = -100) -> int:
    """One label id drawn with probability proportional to its soft score
    (one ``rng.choice``); ``ignore_id`` when no score is positive."""
    scores = np.asarray(scores, dtype=np.float64)
    if scores.size == 0 or scores.sum() <= 0:
        return ignore_id
    idx = rng.choice(len(labels), p=scores / scores.sum())
    return int(labels[idx])


def masked_language_modeling(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    rng: np.random.Generator,
    mask_token_id: int,
    vocab_size: int,
    special_ids: Sequence[int] = (),
    mask_rate: float = 0.15,
    mask_token_rate: float = 0.8,
    random_token_rate: float = 0.1,
    ignore_id: int = -100,
) -> Tuple[np.ndarray, np.ndarray]:
    """Corrupt ``mask_rate`` of the real, non-special tokens: of those,
    ``mask_token_rate`` become ``mask_token_id``, ``random_token_rate`` a
    random id, the rest stay. Returns (corrupted ids, masked labels), the
    labels ``ignore_id`` where nothing was chosen. Draws: one uniform per
    position (chosen), one per position (action), then the random ids."""
    input_ids = np.asarray(input_ids).copy()
    labels = np.full_like(input_ids, ignore_id)
    special = np.isin(input_ids, np.asarray(list(special_ids), dtype=input_ids.dtype))
    candidates = (np.asarray(attention_mask) > 0) & ~special
    coin = rng.random(input_ids.shape)
    chosen = candidates & (coin < mask_rate)
    labels[chosen] = input_ids[chosen]
    action = rng.random(input_ids.shape)
    do_mask = chosen & (action < mask_token_rate)
    do_rand = chosen & (action >= mask_token_rate) & (action < mask_token_rate + random_token_rate)
    input_ids[do_mask] = mask_token_id
    n_rand = int(do_rand.sum())
    if n_rand:
        input_ids[do_rand] = rng.integers(0, vocab_size, size=n_rand)
    return input_ids, labels


def masked_feature_modeling(
    features: np.ndarray,
    mask: Optional[np.ndarray],
    rng: np.random.Generator,
    feature_mask_rate: float = 0.15,
    mask_token_rate: float = 0.8,
    random_token_rate: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Corrupt ``feature_mask_rate`` of the valid rows of (n, d) float32
    ``features`` (``mask`` (n,), None = all valid): of those,
    ``mask_token_rate`` are zeroed, ``random_token_rate`` replaced by a
    random row (read after the zeroing), the rest kept. Returns (features,
    chosen rows as a boolean (n,))."""
    features = np.asarray(features, dtype=np.float32).copy()
    n = features.shape[0]
    valid = np.asarray(mask, dtype=bool) if mask is not None else np.ones((n,), dtype=bool)
    coin = rng.random(n)
    chosen = valid & (coin < feature_mask_rate)
    action = rng.random(n)
    do_zero = chosen & (action < mask_token_rate)
    do_swap = chosen & (action >= mask_token_rate) & (action < mask_token_rate + random_token_rate)
    features[do_zero] = 0.0
    swap_idx = np.flatnonzero(do_swap)
    if swap_idx.size:
        src = rng.integers(0, n, size=swap_idx.size)
        features[swap_idx] = features[src]
    return features, chosen
