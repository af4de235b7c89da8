"""Mask generation: AF-guided curriculum masking, span and random masks.

Copy of the numpy half of rag_snvbert_tpu/data/masking.py (:29-113): the
host-side masks are bit-identical to the JAX package's.  Its ``*_jax``
variants (:120-131) have no caller on the port's path and are left out.

All mask generators are pure functions of ``(seed, window_idx, level, af)`` —
the determinism trick the reference uses to keep DataLoader workers and the
main process in sync (src/dataset/embedding_rag_dataset.py:509-545, seed =
``seed*10000 + window_idx``).

Masks are defined over the *raw window* (length = n_sites); pad with
``tokenize.sequence_padding`` to MAX_SEQ_LEN coordinates (slot 0 = SOS stays
unmasked) before applying to token sequences.

Reference parity:
  - curriculum rates [0.30..0.80] + add_level (src/dataset/dataset.py:252,
    362-374)
  - AF-guided probability map: AF < 0.05 -> 0.7 else curriculum rate
    (src/dataset/embedding_rag_dataset.py:156-167, 228-283)
  - generate_mask(probs) vectorized bernoulli (src/dataset/dataset.py:377-403)
  - span_mask / random_mask (src/dataset/dataset.py:405-447)
"""

from __future__ import annotations

import numpy as np

# Curriculum mask rates (src/dataset/dataset.py:252).
MASK_RATES: tuple[float, ...] = (0.30, 0.40, 0.50, 0.60, 0.70, 0.80)
MAX_LEVEL = len(MASK_RATES) - 1

# AF-guided masking constants (src/dataset/embedding_rag_dataset.py:156-158).
RARE_AF_THRESHOLD = 0.05
RARE_MASK_RATE = 0.7

# Fixed validation masking (src/train_embedding_rag.py:274-291): the code
# calls add_level() x4 (level 4 -> rate 0.70 for common sites) with a fixed
# seed, although its comments claim "50%" — a comment/code drift in the
# reference.  We follow the code: VAL_LEVEL = 4, VAL_SEED = 2024.
VAL_SEED = 2024
VAL_LEVEL = 4


def mask_rate(level) -> float:
    """Common-site mask rate: an int indexes the discrete curriculum
    (MASK_RATES); a float is a continuous rate directly (the
    AdaptiveMaskScheduler path, adaptive_mask_ratio below)."""
    if isinstance(level, (int, np.integer)):
        return MASK_RATES[min(level, MAX_LEVEL)]
    return float(level)


def af_guided_probs(af: np.ndarray, level) -> np.ndarray:
    """Per-site mask probabilities: rare sites (AF < 0.05) masked at 70%,
    common sites at the curriculum rate (``level``: int curriculum level or
    float continuous rate)."""
    return np.where(np.asarray(af) < RARE_AF_THRESHOLD, RARE_MASK_RATE,
                    mask_rate(level)).astype(np.float32)


def window_seed(seed: int, window_idx: int) -> int:
    """Per-(seed, window) RNG seed (embedding_rag_dataset.py:533)."""
    return seed * 10000 + window_idx


def generate_mask(length: int, seed: int, window_idx: int,
                  probs: np.ndarray | None = None,
                  ratio: float | None = None) -> np.ndarray:
    """Deterministic bernoulli mask over a raw window.

    Exactly one of ``probs`` (per-site probabilities) or ``ratio`` (uniform)
    must be given.  Returns int32 0/1 array of ``length``.
    """
    rng = np.random.default_rng(window_seed(seed, window_idx))
    p = probs if probs is not None else np.full(length, ratio, np.float32)
    return (rng.random(length) < p).astype(np.int32)


def af_guided_mask(af: np.ndarray, level: int, seed: int,
                   window_idx: int) -> np.ndarray:
    """The main-path mask: AF-guided bernoulli, deterministic per
    (seed, window)."""
    af = np.asarray(af)
    return generate_mask(af.shape[0], seed, window_idx,
                         probs=af_guided_probs(af, level))


def span_mask(length: int, ratio: float, seed: int, window_idx: int) -> np.ndarray:
    """Contiguous span mask (src/dataset/dataset.py:405-425)."""
    rng = np.random.default_rng(window_seed(seed, window_idx))
    span = int(length * ratio)
    start = int(rng.integers(0, length - span + 1)) if span < length else 0
    mask = np.zeros(length, dtype=np.int32)
    mask[start : start + span] = 1
    return mask


def adaptive_mask_ratio(epoch: int, total_epochs: int,
                        start: float = 0.15, end: float = 0.8,
                        schedule: str = "cosine") -> float:
    """Continuous mask-ratio schedules (AdaptiveMaskScheduler,
    src/main/pretrain.py:21-36): cosine / linear / exponential ramp from
    ``start`` to ``end`` over the run — the alternative to the discrete
    level curriculum."""
    t = min(max(epoch / max(total_epochs - 1, 1), 0.0), 1.0)
    if schedule == "linear":
        f = t
    elif schedule == "exponential":
        f = t ** 2
    else:  # cosine
        f = 0.5 * (1.0 - np.cos(np.pi * t))
    return float(start + (end - start) * f)
