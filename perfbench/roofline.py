"""Peak rates of the chip and the work of the kernels, counted from shapes.

Copied from the sound roofline arithmetic of the repository's
``chip_smoke.py`` (its constants and ``encoder_ops`` / ``bound_ms``), so
that the yardstick cannot move with the program:

* HBM3 bandwidth 3.35 TB/s: NVIDIA H100 SXM data sheet (700 W).
* 32-bit integer add and logic at 64 a clock per SM: CUDA C++ Programming
  Guide, arithmetic instruction throughput, compute capability 9.0.
* The b1 tensor-core rate: ``mma.sync`` m16n8k256 b1 ``.and.popc`` issued
  at 0.471 a clock per SM, measured on an NVIDIA H100 80GB HBM3 at 700 W
  by the repository's ``tools/search_mma_probe.py``; NVIDIA publishes no
  b1 rate.  Each bit agreement counts as 2 operations (an AND and an add).
* Rates given a clock are taken at 132 SMs x 1,980 MHz, the H100 SXM's
  SM count and its maximum SM clock as ``nvidia-smi`` reports it.  The
  card's actual clock and power limit are printed beside every run.

The work is the algorithm's, whatever implements it: the encode is 3
integer operations a word-gram (one XOR of the rolling bind, one
carry-save full adder of the bit-sliced count), the search ``2 B S D``
bit operations, and the bytes are the prototypes, the tokens and the
``(B, S)`` int32 output, each once.
"""

from __future__ import annotations

SMS = 132
SM_CLOCK_HZ = 1.980e9
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_SM_CLOCK = 64
B1_MMA_PER_SM_CLOCK = 0.471
B1_OPS_PER_MMA = 2 * 16 * 8 * 256
ENCODE_OPS_PER_WORD_GRAM = 3

INT32_OPS_PER_S = INT32_OPS_PER_SM_CLOCK * SMS * SM_CLOCK_HZ
B1_OPS_PER_S = B1_MMA_PER_SM_CLOCK * B1_OPS_PER_MMA * SMS * SM_CLOCK_HZ


def fused_least_s(batch: int, read_len: int, grams: int, prototypes: int,
                  dim: int) -> float:
    """Least time of one fused encode -> search launch: the larger of the
    encode's integer operations, the search's b1 operations (separate
    units, so they may overlap) and the bytes once at HBM bandwidth.

    ``grams`` is the sum over the batch of each read's valid n-grams,
    ``max(length - n + 1, 0)``.
    """
    w = dim // 32
    t_encode = grams * w * ENCODE_OPS_PER_WORD_GRAM / INT32_OPS_PER_S
    t_search = 2 * batch * prototypes * dim / B1_OPS_PER_S
    nbytes = prototypes * w * 4 + batch * read_len * 4 + batch * 4 \
        + batch * prototypes * 4
    return max(t_encode, t_search, nbytes / HBM_BYTES_PER_S)
