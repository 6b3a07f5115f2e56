"""The least time of one read event of the simulated crossbar AM, counted
from its shapes (``pcm_sim`` and ``racetrack_sim``'s read, whatever
kernels implement it).

One event reads a batch of ``B`` queries against both banks of ``T =
ceil(D / rows)`` row tiles and ``S_pad`` columns (the prototypes padded to
a multiple of ``cols``).  Its work:

* the tile products in float32: 2 banks x 2 B S_pad D_pad operations
  (``D_pad = T rows``), at the card's float32 rate outside the tensor
  cores: 128 float32 lanes a clock per SM (CUDA C++ Programming Guide,
  arithmetic instruction throughput, compute capability 9.0: 128 results
  of a 32-bit floating-point multiply-add a clock per SM), 2 operations a
  multiply-add, at ``roofline.py``'s 132 SMs x 1,980 MHz: 66.9 TFLOP/s,
  the H100 SXM data sheet's 67 TFLOP/s;
* the read noise: 2 banks x T B S_pad normals, 75 integer operations a
  draw (a Threefry-2x32 pair and the normal's epilogue, the count
  chip_smoke.py gives the Threefry kernel) at ``roofline.py``'s 32-bit
  integer rate;
* the bytes: both banks' float32 read weights (2 T S_pad rows), the
  packed queries (B D / 32 words) and the ``(B, S)`` int32 agreement,
  each once, at ``roofline.py``'s HBM bandwidth.

The products are a separate unit from the integer pipes, so the least
time is the largest of the three.
"""

from __future__ import annotations

from perfbench import roofline

FP32_LANES_PER_SM_CLOCK = 128
FP32_OPS_PER_S = FP32_LANES_PER_SM_CLOCK * 2 * roofline.SMS \
    * roofline.SM_CLOCK_HZ
THREEFRY_OPS_PER_DRAW = 75


def read_work(batch: int, prototypes: int, dim: int, rows: int = 256,
              cols: int = 256) -> dict[str, int]:
    """``flops``, ``draws`` and ``bytes`` of one read event."""
    tiles = -(-dim // rows)
    s_pad = -(-prototypes // cols) * cols
    return {"flops": 2 * 2 * batch * s_pad * tiles * rows,
            "draws": 2 * tiles * batch * s_pad,
            "bytes": 2 * tiles * s_pad * rows * 4 + batch * (dim // 32) * 4
            + batch * prototypes * 4}


def read_least_s(batch: int, prototypes: int, dim: int, rows: int = 256,
                 cols: int = 256) -> float:
    w = read_work(batch, prototypes, dim, rows, cols)
    return max(w["flops"] / FP32_OPS_PER_S,
               w["draws"] * THREEFRY_OPS_PER_DRAW / roofline.INT32_OPS_PER_S,
               w["bytes"] / roofline.HBM_BYTES_PER_S)
