"""The plain reference of Acc-Demeter's in-memory search on PCM crossbars.

Written from the device model's description (Acc-Demeter keeps the
associative memory in phase-change-memory crossbars, arXiv:2206.01932;
the cell figures follow Karunaratne et al., "In-memory hyperdimensional
computing", Nature Electronics 2020) in plain torch, float32, with TF32
off for matmul and cuDNN.  It imports nothing of the program.

1. Cell.  A bit is stored as a conductance ``g = g_off + bit (g_on -
   g_off)`` (uS).  Programming adds a normal spread of ``prog_sigma``
   level spacings (the spacing is ``(g_on - g_off) / (levels - 1)``);
   drift then scales ``g`` by ``(t / 1 s) ** -nu`` after ``t = drift_t_s``
   seconds (when ``nu > 0`` and ``t > 1``); stuck-at faults pin a cell to
   ``g_on`` where a uniform draw ``u < stuck_on_rate`` and to ``g_off``
   where ``u > 1 - stuck_off_rate``; ``g >= 0``.
2. Read weight.  The periphery divides out ``drift ** calibration`` (its
   reference cells' estimate) and inverts the window: ``w = (g / drift **
   calibration - g_off) / (g_on - g_off)``, exactly the bit on an ideal
   cell.
3. Arrays.  ``rows x cols`` arrays: the dimension D is split over ``T =
   ceil(D / rows)`` row tiles and the prototypes over column tiles
   (``S_pad``, a multiple of ``cols``).  Two banks: bank 0 stores the
   prototype bits and is driven by the query bits, bank 1 stores their
   complements (padded prototypes store ones there) and is driven by the
   complement; padded dimensions store zeros and are never driven.
4. Tile read.  Each bit line of a tile sums ``q_r w_r`` over the tile's
   rows (float32), plus bit-line read noise: a normal of ``read_sigma``
   level spacings times ``sqrt(active rows)`` (the query's driven rows in
   the tile), through the same calibration divide and window as the
   signal: ``count + (std * normal) / (drift ** calibration * window)``.
5. ADC.  ``code = round(count / step)`` clipped to ``[0, 2**adc_bits -
   1]``, times ``step``; ``step`` is one count when the converter resolves
   every count (``2**adc_bits - 1 >= rows``), else ``rows / levels``.  The
   tiles' codes are summed per bank, the banks added, and the agreement is
   ``clip(round(sum), 0, D)``.
6. Species max.  The largest agreement over each species' prototypes.

Draws are JAX's Threefry-2x32 (``jax.random``), keyed per bank (stream 0,
1) and per source (0 programming, 1 fault map, 2 read):
``fold_in(fold_in(key(seed), stream), source)``; a read event folds in
its batch's digest (the wrapping uint32 sum of the batch's packed query
words) and splits into one key per row tile.  Programming draws one
normal and one uniform over each bank's ``(T, S_pad, rows)`` cells; a
tile's read draws ``(B, S_pad)`` normals for the whole batch ``B``, of
which a row takes its own slice.  The block function is
:mod:`perfbench.reference.threefry`'s (a torch copy of it,
:func:`threefry2x32`, for bulk draws on the device); both of JAX's
``jax_threefry_partitionable`` modes are written out:

* partitionable: word ``i`` is ``out0 ^ out1`` of the counters
  ``(hi32(i), lo32(i))``;
* original: the counters ``0 .. n - 1`` (one zero more for an odd ``n``)
  pair as ``(j, j + ceil(n / 2))`` and the words are ``concat(out0,
  out1)``.

``uniform`` takes a word's 23 high bits as a float in ``[1, 2)`` less 1,
then ``max(lo, f (hi - lo) + lo)`` with one rounding; ``normal`` is
``sqrt(2) erf_inv(uniform(nextafter(-1, 0), 1))`` with XLA's float32
``ErfInv`` (Giles' single-precision polynomial).  Departures: each fused
multiply-add is computed in float64 and rounded once to float32 (a sum
that float64 rounds onto a float32 halfway point may differ in its last
bit), and ``log1p`` is torch's on the device, not XLA's.

Everything is computed in blocks: a bank's cells a few row tiles at a
time, and a read only for the batch rows it is asked for.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from perfbench.reference import hdc, threefry

M32 = 0xFFFFFFFF
#: Elements of one block's int64 draw, to bound memory.
BLOCK = 1 << 25
PROG, FAULT, READ = 0, 1, 2
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(math.sqrt(2.0)))
#: Giles' single-precision ErfInv as XLA writes it, highest degree first:
#: on ``w - 2.5`` for ``w < 5``, else on ``sqrt(w) - 3``.
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)
PRESETS = {
    "ideal": {},
    # ~8 % programming spread, ~3 % read fluctuation, nu = 0.05 drift read
    # back after a day with 90 % calibration, 1e-3 stuck cells a polarity.
    "pcm": dict(prog_sigma=0.08, read_sigma=0.03, drift_nu=0.05,
                drift_t_s=86_400.0, drift_calibration=0.9,
                stuck_on_rate=1e-3, stuck_off_rate=1e-3),
}


def f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Device:
    """The PCM cells and the crossbar geometry (defaults: an ideal cell,
    256 x 256 arrays, a 9-bit ADC, device seed 0xACCDE)."""

    g_on_us: float = 20.0
    g_off_us: float = 0.1
    levels: int = 2
    prog_sigma: float = 0.0
    read_sigma: float = 0.0
    drift_nu: float = 0.0
    drift_t_s: float = 0.0
    drift_calibration: float = 1.0
    stuck_on_rate: float = 0.0
    stuck_off_rate: float = 0.0
    seed: int = 0xACCDE
    rows: int = 256
    cols: int = 256
    adc_bits: int = 9

    @classmethod
    def from_options(cls, options: dict) -> "Device":
        """From a configuration's ``backend_options``: a ``preset``, then
        any field by name."""
        opts = dict(options)
        if opts.pop("substrate", "pcm") != "pcm":
            raise ValueError("the reference models the pcm substrate only")
        return cls(**{**PRESETS[opts.pop("preset", "ideal")], **opts})

    @property
    def window(self) -> float:
        return self.g_on_us - self.g_off_us

    @property
    def spacing(self) -> float:
        return self.window / (self.levels - 1)

    @property
    def drift(self) -> float:
        if self.drift_nu == 0.0 or self.drift_t_s <= 1.0:
            return 1.0
        return float(self.drift_t_s ** -self.drift_nu)

    @property
    def calibration(self) -> float:
        return self.drift ** self.drift_calibration

    @property
    def adc(self) -> tuple[int, float]:
        """``(levels, step)`` of the converter."""
        levels = (1 << self.adc_bits) - 1
        return levels, 1.0 if levels >= self.rows else self.rows / levels


# -- keys and draws -----------------------------------------------------------

def _np_block(key, x0, x1):
    return threefry.threefry2x32((int(key[0]), int(key[1])),
                                 np.asarray(x0, np.uint32),
                                 np.asarray(x1, np.uint32))


def key(seed: int) -> tuple[int, int]:
    return 0, int(seed) & M32


def fold_in(k, data: int) -> tuple[int, int]:
    o0, o1 = _np_block(k, [0], [int(data) & M32])
    return int(o0[0]), int(o1[0])


def split(k, n: int, partitionable: bool) -> np.ndarray:
    """``(n, 2)`` uint32 keys."""
    if partitionable:
        o0, o1 = _np_block(k, np.zeros(n), np.arange(n))
        return np.stack([o0, o1], axis=1)
    o0, o1 = _np_block(k, np.arange(n), np.arange(n, 2 * n))
    return np.concatenate([o0, o1]).reshape(n, 2)


def sub_key(seed: int, stream: int, source: int) -> tuple[int, int]:
    return fold_in(fold_in(key(seed), stream), source)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The block function of :mod:`perfbench.reference.threefry` on int64
    tensors holding 32-bit words (keys broadcast against counters)."""
    ks = (k0, k1, k0 ^ k1 ^ threefry._PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for step in range(5):
        for r in threefry._ROTATIONS[step % 2]:
            x0.add_(x1).bitwise_and_(M32)
            hi = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_and_(M32).bitwise_or_(hi)
            x1.bitwise_xor_(x0)
        x0 = (x0 + ks[(step + 1) % 3]) & M32
        x1 = (x1 + ks[(step + 2) % 3] + (step + 1)) & M32
    return x0, x1


def words_at(keys, idx: torch.Tensor, total: int, partitionable: bool
             ) -> torch.Tensor:
    """Words ``idx`` (int64, any shape) of each key's draw of ``total``
    words: ``(N, *idx.shape)`` int64 for ``(N, 2)`` keys."""
    kt = torch.as_tensor(np.asarray(keys, np.int64).reshape(-1, 2),
                         device=idx.device)
    shape = (-1,) + (1,) * idx.dim()
    k0, k1 = kt[:, 0].reshape(shape), kt[:, 1].reshape(shape)
    idx = idx[None]
    if partitionable:
        o0, o1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
        return o0 ^ o1
    half = (total + 1) // 2
    low = idx < half
    x0 = torch.where(low, idx, idx - half)
    x1 = x0 + half
    x1 = torch.where(x1 < total, x1, torch.zeros_like(x1))
    o0, o1 = threefry2x32(k0, k1, x0, x1)
    return torch.where(low, o0, o1)


def _fma(a: torch.Tensor, b, c: float) -> torch.Tensor:
    b = b.double() if isinstance(b, torch.Tensor) else f32(b)
    return (a.double() * b + f32(c)).float()


def uniform_at(keys, idx, total, partitionable, lo=0.0, hi=1.0):
    w = words_at(keys, idx, total, partitionable)
    f = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp_min(_fma(f, float(hi32 - lo32), float(lo32)),
                           float(lo32))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, ERFINV_SMALL[0], ERFINV_LARGE[0]).to(torch.float32)
    for cs, cl in zip(ERFINV_SMALL[1:], ERFINV_LARGE[1:]):
        p = torch.where(small, _fma(p, w, cs), _fma(p, w, cl))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal_at(keys, idx, total, partitionable) -> torch.Tensor:
    return SQRT2 * erf_inv(uniform_at(keys, idx, total, partitionable,
                                      NORMAL_LO, 1.0))


# -- programming --------------------------------------------------------------

@dataclasses.dataclass
class Banks:
    """Both banks' read weights, ``(T, S_pad, rows)`` float32 each."""

    pos: torch.Tensor
    neg: torch.Tensor
    dim: int
    num_prototypes: int
    device_model: Device
    partitionable: bool


def _tile_bits(words: torch.Tensor, dim: int, t0: int, t1: int, rows: int,
               s_pad: int, complement: bool) -> torch.Tensor:
    """Row tiles ``t0 .. t1 - 1`` of one bank's stored bits, ``(t1 - t0,
    S_pad, rows)`` float32."""
    d0, d1 = t0 * rows, min(t1 * rows, dim)
    out = torch.zeros((s_pad, (t1 - t0) * rows), dtype=torch.float32,
                      device=words.device)
    if d1 > d0:
        w0 = d0 // 32
        bits = hdc.unpack(words[:, w0:-(-d1 // 32)])[:, d0 - 32 * w0:
                                                     d1 - 32 * w0]
        out[:bits.shape[0], :d1 - d0] = bits.to(torch.float32)
        if complement:
            out[:, :d1 - d0] = 1.0 - out[:, :d1 - d0]
    return out.reshape(s_pad, t1 - t0, rows).transpose(0, 1)


def program(prototypes: torch.Tensor, dim: int, dev: Device,
            partitionable: bool) -> Banks:
    """Program ``(S, W)`` packed prototypes into both banks."""
    s = prototypes.shape[0]
    t = -(-dim // dev.rows)
    s_pad = -(-s // dev.cols) * dev.cols
    cells = t * s_pad * dev.rows
    step = max(1, BLOCK // (s_pad * dev.rows))
    div = torch.tensor(f32(dev.calibration), device=prototypes.device)
    win = torch.tensor(f32(dev.window), device=prototypes.device)
    banks = []
    for stream in (0, 1):
        w = torch.empty((t, s_pad, dev.rows), dtype=torch.float32,
                        device=prototypes.device)
        for t0 in range(0, t, step):
            t1 = min(t, t0 + step)
            g = _tile_bits(prototypes, dim, t0, t1, dev.rows, s_pad,
                           stream == 1) * f32(dev.window) + f32(dev.g_off_us)
            idx = torch.arange(t0 * s_pad * dev.rows, t1 * s_pad * dev.rows,
                               device=prototypes.device).reshape(g.shape)
            if dev.prog_sigma > 0:
                g += f32(dev.prog_sigma * dev.spacing) * normal_at(
                    sub_key(dev.seed, stream, PROG), idx, cells,
                    partitionable)[0]
            if dev.drift != 1.0:
                g = g * f32(dev.drift)
            if dev.stuck_on_rate > 0 or dev.stuck_off_rate > 0:
                u = uniform_at(sub_key(dev.seed, stream, FAULT), idx, cells,
                               partitionable)[0]
                g.masked_fill_(u < f32(dev.stuck_on_rate), f32(dev.g_on_us))
                g.masked_fill_(u > f32(1.0 - dev.stuck_off_rate),
                               f32(dev.g_off_us))
            w[t0:t1] = (g.clamp_min_(0.0) / div - f32(dev.g_off_us)) / win
        banks.append(w)
    return Banks(banks[0], banks[1], dim, s, dev, partitionable)


# -- reading ------------------------------------------------------------------

def digest(queries: torch.Tensor) -> int:
    """The wrapping uint32 sum of a batch's packed query words."""
    return int((queries.to(torch.int64) & M32).sum()) & M32


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties even)."""
    b = x.view(torch.int32)
    return ((b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _products(q: torch.Tensor, w: torch.Tensor, precision: str
              ) -> torch.Tensor:
    """``(T, n, rows) x (T, S_pad, rows) -> (T, n, S_pad)``: float32 with
    TF32 off, or the control ``"tf32"`` (TF32 on the card; on the host,
    operands rounded to TF32)."""
    tf = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    if on and q.device.type != "cuda":
        q, w = _tf32(q), _tf32(w)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        return torch.bmm(q, w.transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf


def read(queries: torch.Tensor, rows: np.ndarray, banks: Banks,
         precision: str = "float32") -> torch.Tensor:
    """The agreements of batch rows ``rows`` of one read event over the
    whole ``(B, W)`` batch of packed queries: ``(n, S)`` int32."""
    dev, dim = banks.device_model, banks.dim
    t, s_pad, r = banks.pos.shape
    b = queries.shape[0]
    levels, step = dev.adc
    k = digest(queries)
    tile_keys = [split(fold_in(sub_key(dev.seed, stream, READ), k), t,
                       banks.partitionable) for stream in (0, 1)]
    divisor = f32(dev.calibration * dev.window)
    per = max(1, BLOCK // (t * s_pad))
    out = []
    for i in range(0, len(rows), per):
        sel = torch.as_tensor(np.asarray(rows[i:i + per], np.int64),
                              device=queries.device)
        bits = hdc.unpack(queries[sel]).to(torch.float32)       # (n, D)
        total = None
        for stream in (0, 1):
            q = bits if stream == 0 else 1.0 - bits
            q = torch.nn.functional.pad(q, (0, t * r - dim))
            q = q.reshape(len(sel), t, r).transpose(0, 1).contiguous()
            count = _products(q, banks.neg if stream else banks.pos,
                              precision)
            if dev.read_sigma > 0:
                std = f32(dev.read_sigma * dev.spacing) * torch.sqrt(
                    q.sum(-1))
                idx = sel[:, None] * s_pad + torch.arange(
                    s_pad, device=sel.device)
                noise = normal_at(tile_keys[stream], idx, b * s_pad,
                                  banks.partitionable)
                count = count + (std[..., None] * noise) / torch.tensor(
                    divisor, device=count.device)
            if step != 1.0:
                count = count / torch.tensor(f32(step), device=count.device)
            code = torch.round(count).clamp_(0, levels)
            if step != 1.0:
                code = code * f32(step)
            part = code.sum(0)
            total = part if total is None else total + part
        out.append(torch.round(total).clamp_(0, dim).to(torch.int32))
    return torch.cat(out)[:, :banks.num_prototypes]


def species_max(agreement: torch.Tensor, species_rows: list[tuple[int, int]]
                ) -> torch.Tensor:
    """``(n, S)`` agreements -> ``(n, species)`` int32, each species the
    largest over its prototype columns ``[lo, hi)``."""
    return torch.stack([agreement[:, lo:hi].max(dim=1).values
                        for lo, hi in species_rows], dim=1)
