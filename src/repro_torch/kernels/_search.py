"""What the two standalone search kernels share on the Python side:
``hamming_am`` and ``am_matmul``'s packed entry take the same packed
operands and cut them alike: query tiles of 256 rows and the slab of
prototypes ``mma::slab::pick_nt`` chooses (``csrc/mma_common.cuh``).
"""

from __future__ import annotations

import torch

#: Queries one block covers (``mma::slab::kRows``); the grid's second
#: axis holds at most 65,535 query tiles.
BLOCK_B = 256


def check_packed(q, p, who: str) -> None:
    """Raise ``ValueError`` on packed operands the search kernels do not
    take (``who`` names the entry in the message)."""
    for name, t in (("q_packed", q), ("p_packed", p)):
        if t.device != q.device:
            raise ValueError(f"{who}: {name} is on {t.device}, "
                             f"q_packed on {q.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{who}: {name} must be int32 bit "
                             f"patterns, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous "
                             f"2-d tensor, got shape {tuple(t.shape)}")
    if q.shape[1] != p.shape[1]:
        raise ValueError(f"{who}: q_packed {tuple(q.shape)} and "
                         f"p_packed {tuple(p.shape)} differ in W")
    if -(-q.shape[0] // BLOCK_B) > 65535:
        raise ValueError(f"{who}: at most {65535 * BLOCK_B} "
                         f"queries per launch, got {q.shape[0]}")
