"""Deterministic synthetic LM data pipeline (training substrate).

A copy of :mod:`repro.data.lm_data` (numpy only): the same ``(seed,
step)`` gives the same arrays in both packages.

Two token sources:

* ``genome_stream`` — DNA tokens from the synthetic community mapped into
  the model vocab; the "food profiling meets LM" corpus used by examples.
* ``structured_stream`` — a mixture of copy/repeat/arithmetic patterns
  with genuine sequential structure, so a ~100M model's loss visibly
  drops within a few hundred steps (examples/train_lm.py).

Determinism contract (fault tolerance): ``batch_at(step)`` is a pure
function of (seed, step), so a restarted job replays the identical data
order with no iterator state to checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "structured"          # structured | genome


def _structured_row(rng: np.random.Generator, seq_len: int, vocab: int
                    ) -> np.ndarray:
    """One sequence with learnable structure."""
    mode = rng.integers(0, 3)
    usable = max(vocab - 4, 8)
    if mode == 0:                     # periodic repeat of a random motif
        p = int(rng.integers(2, 9))
        motif = rng.integers(0, usable, p)
        reps = -(-seq_len // p)
        return np.tile(motif, reps)[:seq_len].astype(np.int32)
    if mode == 1:                     # arithmetic ramp mod usable
        start = int(rng.integers(0, usable))
        stride = int(rng.integers(1, 5))
        return ((start + stride * np.arange(seq_len)) % usable).astype(np.int32)
    # copy task: random prefix, then the same prefix again, repeated
    half = max(seq_len // 2, 1)
    prefix = rng.integers(0, usable, half)
    reps = -(-seq_len // half)
    return np.tile(prefix, reps)[:seq_len].astype(np.int32)


def batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Batch for a given step: {'tokens', 'labels'} (labels = shifted)."""
    rng = np.random.default_rng((cfg.seed << 32) ^ step)
    b, s = cfg.global_batch, cfg.seq_len
    if cfg.kind == "genome":
        toks = rng.integers(0, 4, (b, s + 1)).astype(np.int32)
    else:
        toks = np.stack([_structured_row(rng, s + 1, cfg.vocab)
                         for _ in range(b)])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
