"""N-gram HD encoder: binding (XOR + permutation) and bundling (majority).

Counterpart of :mod:`repro.core.encoder` (paper Eq. 1):

    gram_i = B[c_i]  XOR  rho(B[c_{i+1}])  XOR ... XOR  rho^{N-1}(B[c_{i+N-1}])

followed by per-bit counters over all valid grams of a sequence and a
majority threshold (exact ties take the tie-break vector's bit).

* ``encode_grams`` -- gather-based, materializes all grams; the oracle
  of the encoder kernel's plain version.
* ``bundle_counts`` -- the rolling-gram recurrence
  ``gram_{i+1} = rho^-1(gram_i ^ B[c_i]) ^ rho^{N-1}(B[c_{i+N}])``, a
  Python loop of O(B*D) tensor steps (``repro`` runs it in a
  ``lax.fori_loop``).
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.core.hd_space import HDSpace


def num_grams(seq_len: int, n: int) -> int:
    return max(seq_len - n + 1, 0)


def valid_grams(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """``m = max(length - n + 1, 0)`` per sequence, int32."""
    return torch.clamp(lengths.to(torch.int32) - (n - 1), min=0)


def encode_grams(tokens: torch.Tensor, im_rolled: torch.Tensor) -> torch.Tensor:
    """All n-gram HD vectors of ``tokens``.

    Args:
      tokens: ``(..., L)`` integer symbol ids in [0, alphabet).
      im_rolled: ``(N, alphabet, W)`` from :func:`item_memory.rolled`.

    Returns:
      ``(..., L-N+1, W)`` packed gram vectors.
    """
    n = im_rolled.shape[0]
    g = num_grams(tokens.shape[-1], n)
    toks = tokens.long()
    acc = im_rolled[0][toks[..., 0:g]]
    for j in range(1, n):
        acc = torch.bitwise_xor(acc, im_rolled[j][toks[..., j:j + g]])
    return acc


def bundle_counts(tokens: torch.Tensor, lengths: torch.Tensor,
                  im: torch.Tensor, im_last: torch.Tensor, *, n: int,
                  dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bit bundling counters over all valid grams of each sequence.

    Args:
      tokens: ``(B, L)`` integer padded symbol ids.
      lengths: ``(B,)`` true sequence lengths.
      im: ``(alphabet, W)`` packed item memory.
      im_last: ``rho^{N-1}(im)``.

    Returns:
      counts: ``(B, D)`` int32 per-bit counters.
      m: ``(B,)`` int32 number of valid grams per sequence.
    """
    b, length = tokens.shape
    g = num_grams(length, n)
    m = valid_grams(lengths, n)
    counts = torch.zeros((b, dim), dtype=torch.int32, device=tokens.device)
    if g == 0 or b == 0:
        return counts, m
    toks = tokens.long()
    gram = im[toks[:, 0]]                     # gram_0 = XOR_j rho^j(B[c_j])
    for j in range(1, n):
        gram = torch.bitwise_xor(gram, bitops.rho(im[toks[:, j]], j))
    # Grams at i >= max(m) are masked out for every row: stop there (on
    # meta, where there are no lengths to read, run every gram).
    stop = g if m.device.type == "meta" else min(g, int(m.max()))
    for i in range(stop):
        valid = (i < m)[:, None]
        counts += torch.where(valid, bitops.unpack_bits(gram), 0).to(torch.int32)
        nxt_tok = toks[:, min(i + n, length - 1)]
        gram = torch.bitwise_xor(
            bitops.rho(torch.bitwise_xor(gram, im[toks[:, i]]), -1),
            im_last[nxt_tok])
    return counts, m


def binarize_majority(counts: torch.Tensor, m: torch.Tensor,
                      tie_break: torch.Tensor) -> torch.Tensor:
    """Majority threshold over bundling counters -> packed HD vector.

    bit = 1 if 2*count > m; exact ties (even m) take the tie-break bit.
    """
    tie_bits = bitops.unpack_bits(tie_break)
    twice = 2 * counts
    m_col = m[..., None]
    bits = torch.where(twice == m_col, tie_bits, (twice > m_col).to(torch.uint8))
    return bitops.pack_bits(bits)


def encode(tokens: torch.Tensor, lengths: torch.Tensor, im: torch.Tensor,
           tie_break: torch.Tensor, space: HDSpace) -> torch.Tensor:
    """Full encode of a batch of sequences -> ``(B, W)`` packed HD vectors."""
    im_last = bitops.rho(im, space.ngram - 1)
    counts, m = bundle_counts(tokens, lengths, im, im_last,
                              n=space.ngram, dim=space.dim)
    return binarize_majority(counts, m, tie_break)
