"""The plain reference of Demeter's five steps, in PyTorch and NumPy.

Written from the paper's description (arXiv:2206.01932, section 3) and
the settings in the configuration file; it imports nothing of the
program and takes none of its state except where a caller passes the
program's prototypes to follow it step by step (``species_scores``).

1. Space: D bits as ``D / 32`` int32 words, LSB first; ``rho`` rotates
   whole words.  Item memory: A random words vectors, tie vector: one
   more, both from :mod:`perfbench.reference.threefry`.
2. Windows of ``window`` symbols every ``stride`` (a last window ending at
   the genome's end when the stride leaves a tail); one prototype each.
3. Encode: ``gram_i = XOR_j rho^j(IM[c_{i+j}])`` for every valid gram,
   per-bit counts, majority (``2 count > m`` is 1, ``2 count == m`` takes
   the tie bit).  Computed gram by gram from that definition, with no
   rolling recurrence.
4. Agreement ``(D + q.p) / 2`` from +-1 vectors in float32 with TF32 off
   (exact: every sum is an integer below 2**24), the max over each
   species' prototypes, hits at ``int(D/2 + z sqrt(D)/2)`` and the
   category (0 unmapped, 1 unique, 2 multi).
5. Abundance: unique reads to their species; each multi read split over
   its hit species in proportion to unique reads per base, or evenly when
   none of them has unique reads.

``precision="bfloat16"`` computes step 4's product in bfloat16 (products
and output), the control that a lower precision has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import threefry

TIE_SALT = 0x7EB4EA4
UNMAPPED, UNIQUE, MULTI = 0, 1, 2
#: Elements of one step's bit intermediate (int32), to bound memory.
_BUDGET = 2 ** 27


def words(dim: int) -> int:
    if dim % 32:
        raise ValueError(f"dim must be a multiple of 32, got {dim}")
    return dim // 32


def item_memory(space: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(im (A, W), tie (W,))`` int32 bit patterns of the space."""
    if space["density"] != 0.5:
        raise ValueError("the reference draws density 0.5 spaces only")
    w, a = words(space["dim"]), space["alphabet_size"]
    im = threefry.random_words(space["seed"], a * w).view(np.int32)
    tie = threefry.random_words(space["seed"] ^ TIE_SALT, w).view(np.int32)
    return im.reshape(a, w), tie


def threshold(space: dict) -> int:
    d = space["dim"]
    return int(d / 2 + space["z_threshold"] * math.sqrt(d) / 2)


def window_starts(length: int, window: int, stride: int) -> list[int]:
    """Start of each window of a genome of ``length`` symbols."""
    if length <= window:
        return [0]
    starts = list(range(0, length - window + 1, stride))
    if starts[-1] + window < length:
        starts.append(length - window)
    return starts


def unpack(w: torch.Tensor) -> torch.Tensor:
    """``(..., W)`` int32 words -> ``(..., 32 W)`` int32 bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    bits = (w.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*w.shape[:-1], w.shape[-1] * 32)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """``(..., D)`` {0, 1} -> ``(..., D / 32)`` int32 bit patterns."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], -1, 32)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    v = (b * weights).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def encode(tokens: torch.Tensor, lengths: torch.Tensor, im: np.ndarray,
           tie: np.ndarray, ngram: int) -> torch.Tensor:
    """Step 3 (and step 2 per window): ``(R, L)`` symbols -> ``(R, W)``,
    a block of rows at a time."""
    dim = 32 * im.shape[1]
    rows = max(1, _BUDGET // dim)
    return torch.cat([_encode(tokens[r:r + rows], lengths[r:r + rows], im,
                              tie, ngram)
                      for r in range(0, tokens.shape[0], rows)])


def _encode(tokens, lengths, im, tie, ngram):
    dev = tokens.device
    r, w = tokens.shape[0], im.shape[1]
    dim = 32 * w
    im_t = torch.from_numpy(im).to(dev)
    rolled = torch.stack([torch.roll(im_t, j, dims=-1)
                          for j in range(ngram)])           # (n, A, W)
    toks = tokens.long()
    m = torch.clamp(lengths.long() - (ngram - 1), min=0)
    counts = torch.zeros((r, dim), dtype=torch.int32, device=dev)
    grams = int(m.max()) if r else 0
    step = max(1, _BUDGET // max(1, r * dim))
    for i0 in range(0, grams, step):
        idx = torch.arange(i0, min(grams, i0 + step), device=dev)
        g = rolled[0][toks[:, idx]]                           # (R, k, W)
        for j in range(1, ngram):
            g = g ^ rolled[j][toks[:, idx + j]]
        valid = (idx[None, :] < m[:, None]).to(torch.int32)  # (R, k)
        counts += (unpack(g) * valid[..., None]).sum(1, dtype=torch.int32)
    twice, mm = 2 * counts, m[:, None].to(torch.int32)
    tie_bits = unpack(torch.from_numpy(tie).to(dev))[None, :]
    bits = torch.where(twice == mm, tie_bits, (twice > mm).to(torch.int32))
    return pack(bits)


def pm1(words_: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (2 * unpack(words_) - 1).to(dtype)


def species_scores(queries: torch.Tensor, prototypes: torch.Tensor,
                   rows: list[tuple[int, int]],
                   precision: str = "float32") -> torch.Tensor:
    """Step 4's max: ``(R, S)`` int32, the best agreement of each query
    with the prototype rows ``[lo, hi)`` of each species."""
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    dim = 32 * queries.shape[1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q = pm1(queries, dtype)
        out = torch.empty((queries.shape[0], len(rows)), dtype=torch.int32,
                          device=queries.device)
        for s, (lo, hi) in enumerate(rows):
            best = None
            for c in range(lo, hi, 4096):
                p = pm1(prototypes[c:min(hi, c + 4096)], dtype)
                dot = (q @ p.T).to(torch.float64)
                cmax = dot.max(dim=1).values
                best = cmax if best is None else torch.maximum(best, cmax)
            out[:, s] = ((dim + best) / 2).to(torch.int32)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def classify(scores: torch.Tensor, thresh: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hits ``(R, S)`` bool and category ``(R,)`` int32."""
    hits = scores >= thresh
    n = hits.sum(1)
    cat = torch.full_like(n, MULTI)
    cat[n == 1] = UNIQUE
    cat[n == 0] = UNMAPPED
    return hits, cat.to(torch.int32)


def category_of(hits: torch.Tensor) -> torch.Tensor:
    return classify(hits.to(torch.int32), 1)[1]


def report(hits: np.ndarray, genome_lengths: np.ndarray) -> dict:
    """Step 5 from per-read hits: counts and abundances."""
    hits = np.asarray(hits, bool)
    n = hits.sum(1)
    uniq = hits[n == 1].sum(0).astype(np.int64)
    rate = uniq / np.maximum(np.asarray(genome_lengths, np.float64), 1.0)
    multi = hits[n > 1]
    share = multi * rate
    mass = share.sum(1, keepdims=True)
    even = multi / np.maximum(multi.sum(1, keepdims=True), 1)
    split = np.where(mass > 0, share / np.where(mass > 0, mass, 1), even)
    multi_counts = split.sum(0)
    mapped = uniq + multi_counts
    return {"total_reads": len(hits), "unmapped_reads": int((n == 0).sum()),
            "multi_reads": len(multi), "unique_counts": uniq,
            "multi_counts": multi_counts,
            "abundance": mapped / max(mapped.sum(), 1e-30)}
