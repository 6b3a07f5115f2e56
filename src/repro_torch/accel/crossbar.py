"""Tiled in-memory associative-memory search, generic over substrates.

Counterpart of :mod:`repro.accel.crossbar`.  The prototypes live as
physical state in ``rows x cols`` arrays; a query drives the word lines
and each bit line accumulates the dot product of the query bits with one
prototype's effective cell weights.  Agreement (matching bits, 1-1 and
0-0) comes from the differential design: bank 0 stores the prototype bits
and is driven by the query bits, bank 1 stores the complements and is
driven by the complement, ``agreement = count(bank 0) + count(bank 1)``.
The HD dimension is split over ``T`` row tiles (each partial count
digitized by its tile's converter, then summed) and the prototypes over
column tiles (padding to ``S_pad``).

Where ``repro`` ``vmap``s one tile's ``q_tile @ w_tile.T`` over the row
tiles, the port runs one ``torch.bmm`` over the ``(T, B, rows) x (T,
rows, S_pad)`` tiles -- a plain batched float32 product, which JAX also
computes outside any Pallas kernel.  It needs TF32 off on the card
(noisy weights are not integers, and TF32 would round them): PyTorch's
default, which the substrate backends set as the reference backend does.
The read noise of
all ``T`` tiles is drawn by the Threefry kernel straight into the partial
counts (:meth:`Substrate.add_read_noise`).

One read event runs over its row tiles in chunks, each chunk's ``(t, B,
S_pad)`` partial counts under :data:`BLOCK_BYTES` (at D = 40,000 and
29,440 columns all 157 tiles of a batch of 4,096 would take 75.7 GB), and
the two banks are read one after the other, so one chunk's counts are
alive at a time.  Each tile draws its noise with its own key over the
whole batch, so chunking changes no element's noise, code or clip; with a
lossless ADC the codes are whole counts and their float32 sum over the
tiles is exact, so a chunked read equals the one-chunk read bit for bit.

The ADC is behavioral: a per-tile count in ``[0, rows]`` is quantized to
``2**adc_bits - 1`` uniform steps, and with ``adc_bits >= log2(rows + 1)``
the step is one count, so a zero-noise read is bit-exact with the digital
agreement.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.accel.substrate import Substrate, draw_uniform
from repro_torch.core import bitops, threefry
from repro_torch.core.bitops import pad_to_multiple


@dataclasses.dataclass(frozen=True)
class CrossbarConfig:
    """Frozen geometry of one physical array + its converters.

    Attributes:
      rows: word lines per array (HD dimensions per row tile).
      cols: bit lines per array (prototypes per column tile).
      adc_bits: ADC resolution; needs ``>= log2(rows + 1)`` for lossless
        count readout (the default 9 bits covers 256 rows), smaller
        values model a cheaper, lossy converter.
    """

    rows: int = 256
    cols: int = 256
    adc_bits: int = 9

    def __post_init__(self) -> None:
        if self.rows < 1 or self.cols < 1:
            raise ValueError("rows and cols must be >= 1")
        if self.adc_bits < 1:
            raise ValueError("adc_bits must be >= 1")

    @property
    def lossless(self) -> bool:
        """True when the ADC resolves every one of ``rows + 1`` counts."""
        return (1 << self.adc_bits) - 1 >= self.rows

    def num_tiles(self, dim: int, num_protos: int) -> tuple[int, int]:
        """(row tiles, column tiles) covering a ``dim x num_protos`` AM."""
        return (math.ceil(dim / self.rows),
                math.ceil(num_protos / self.cols))

    def num_arrays(self, dim: int, num_protos: int) -> int:
        """Physical arrays for one differential AM (both banks)."""
        rt, ct = self.num_tiles(dim, num_protos)
        return 2 * rt * ct


def _adc_params(cfg: CrossbarConfig) -> tuple[int, float]:
    """``(levels, step)`` of the ADC transfer function."""
    levels = (1 << cfg.adc_bits) - 1
    step = 1.0 if cfg.lossless else cfg.rows / levels
    return levels, step


def _codes(count: torch.Tensor, step: float) -> torch.Tensor:
    """``round(count / step)`` in place (``count`` is consumed); a step of
    exactly one count divides nothing."""
    if step != 1.0:
        count = count.div_(torch.tensor(np.float32(step),
                                        device=count.device))
    return count.round_()


def adc_quantize(count: torch.Tensor, cfg: CrossbarConfig) -> torch.Tensor:
    """Digitize an analog per-tile match count to the ADC's level grid:
    ``clip(round(count / step), 0, levels) * step``."""
    levels, step = _adc_params(cfg)
    code = _codes(count.to(torch.float32).clone(), step).clamp_(0, levels)
    return code if step == 1.0 else code * np.float32(step).item()


#: Bytes of one chunk's ``(t, B, S_pad)`` float32 partial counts: a read
#: event runs over its row tiles in chunks under this cap.
BLOCK_BYTES = 8 << 30


def block_tiles(batch: int, s_pad: int) -> int:
    """Row tiles in one chunk of a read event of ``batch`` queries over
    ``s_pad`` columns (the last chunk may hold fewer)."""
    return max(1, BLOCK_BYTES // (4 * batch * s_pad))


def _bank_counts(qbits: torch.Tensor, wtiles: torch.Tensor, read_key,
                 xcfg: CrossbarConfig, substrate: Substrate, *,
                 clips: torch.Tensor | None = None) -> torch.Tensor:
    """Analog partial-count readout of one bank, in chunks of
    :func:`block_tiles` row tiles.

    Args:
      qbits: ``(T, B, rows)`` float32 query bits per row tile.
      wtiles: ``(T, S_pad, rows)`` float32 effective weights per row tile.
      read_key: key words of this bank's read event; tile ``t`` draws
        with ``split(read_key, T)[t]``, as ``repro``'s ``vmap`` does.
      clips: a device scalar the codes the converter clamped are added
        into, or None.

    Returns:
      ``(B, S_pad)`` float32 accumulated (post-ADC) counts.
    """
    levels, step = _adc_params(xcfg)
    t, b, _ = qbits.shape
    keys = threefry.split(read_key, t, partitionable=substrate.partitionable)
    span = block_tiles(b, wtiles.shape[1])
    out = None
    for t0 in range(0, t, span):
        q = qbits[t0:t0 + span]
        count = torch.bmm(q, wtiles[t0:t0 + span].transpose(1, 2))
        substrate.add_read_noise(keys[t0:t0 + span], count, q.sum(dim=-1))
        code = _codes(count, step)
        if clips is not None:
            clips += ((code < 0) | (code > levels)).sum()
        code.clamp_(0, levels)
        if step != 1.0:
            code.mul_(np.float32(step).item())
        part = code.sum(dim=0)
        del count, code                  # free the chunk before the next
        out = part if out is None else out.add_(part)
    return out


def _to_row_tiles(bits: torch.Tensor, rows: int) -> torch.Tensor:
    """``(N, D)`` bits -> ``(T, N, rows)`` zero-padded row tiles."""
    padded = pad_to_multiple(bits, 1, rows)
    n, d_pad = padded.shape
    return padded.reshape(n, d_pad // rows, rows).transpose(0, 1).contiguous()


def program_prototypes(prototypes: torch.Tensor, xcfg: CrossbarConfig,
                       substrate: Substrate
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpack + tile + program the packed AM into both physical banks:
    ``(state_pos, state_neg)``, each ``(T, S_pad, rows)`` on the
    prototypes' device.  Deterministic in the substrate's seed."""
    pbits = bitops.unpack_bits(prototypes).to(torch.float32)    # (S, D)
    pbits = pad_to_multiple(pbits, 0, xcfg.cols)
    # Complement before the dim-axis padding: pad cells stay OFF in both
    # banks so they never contribute current.
    pos = _to_row_tiles(pbits, xcfg.rows)
    neg = _to_row_tiles(1.0 - pbits, xcfg.rows)
    del pbits
    s_pos = substrate.program(pos, stream=0)
    del pos
    return s_pos, substrate.program(neg, stream=1)


def batch_digest(queries: torch.Tensor) -> int:
    """``repro``'s read-event digest: the wrapping uint32 sum of every
    packed query word (``jnp.sum(queries, dtype=uint32)``)."""
    return int((queries.to(torch.int64) & 0xFFFFFFFF).sum()) & 0xFFFFFFFF


def read_banks(queries: torch.Tensor, w_pos: torch.Tensor,
               w_neg: torch.Tensor, dim: int, xcfg: CrossbarConfig,
               substrate: Substrate, *, with_stats: bool = False):
    """One AM read event against the banks' effective weights (the
    substrate's ``read_weights`` of the programmed state).

    ``(B, W)`` packed queries -> ``(B, S_pad)`` int32 agreement estimates
    clipped to ``[0, dim]``; with ``with_stats`` a ``(result, adc_clips)``
    pair with the same result.  The banks are read one after the other,
    each in chunks of :func:`block_tiles` row tiles; under a running
    ``torch.profiler`` the event is the span ``repro_torch.crossbar.read``.
    """
    with obs.span("repro_torch.crossbar.read"):
        digest = batch_digest(queries)
        qbits = bitops.unpack_bits(queries).to(torch.float32)   # (B, D)
        clips = (torch.zeros((), dtype=torch.int64, device=qbits.device)
                 if with_stats else None)
        total = None
        for stream, (bits, weights) in enumerate(((qbits, w_pos),
                                                  (1.0 - qbits, w_neg))):
            out = _bank_counts(_to_row_tiles(bits, xcfg.rows), weights,
                               substrate.read_event_key(stream, digest),
                               xcfg, substrate, clips=clips)
            total = out if total is None else total.add_(out)
        result = total.round_().clamp_(0, dim).to(torch.int32)
        return (result, int(clips)) if with_stats else result


def crossbar_read(queries: torch.Tensor, s_pos: torch.Tensor,
                  s_neg: torch.Tensor, dim: int, xcfg: CrossbarConfig,
                  substrate: Substrate, *, with_stats: bool = False):
    """One AM read event against already-programmed banks (``repro``'s
    signature): the substrate's ``read_weights`` of both states, then
    :func:`read_banks`."""
    return read_banks(queries, substrate.read_weights(s_pos, stream=0),
                      substrate.read_weights(s_neg, stream=1), dim, xcfg,
                      substrate, with_stats=with_stats)


def roll_tracks(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-track circular roll: ``out[..., j] = x[..., (j - k) % rows]``.

    ``k`` holds one integer offset per track (the leading axes of ``x``).
    Only the tracks with a non-zero offset are moved, one ``torch.roll``
    per distinct offset, so a bank with a few misaligned tracks costs one
    copy and a gather of those tracks (``repro``'s ``take_along_axis``
    would build a full index tensor).
    """
    out = x.clone()
    for v in torch.unique(k).tolist():
        if v == 0:
            continue
        sel = k == v
        out[sel] = torch.roll(x[sel], int(v), dims=-1)
    return out


def write_verify_bits(prototypes: torch.Tensor, xcfg: CrossbarConfig,
                      substrate: Substrate, *,
                      probe_seed: int = 0x5EED) -> torch.Tensor:
    """Fault-aware programming: pick stored bits that minimize readout
    bias (``repro``'s write-verify pass).

    Three probe programs a bank -- all zeros, all ones and a fixed
    pseudo-random pattern from ``key(probe_seed)`` -- identify each cell's
    read-back ``W0`` / ``W1`` and each track's access offset ``k`` (the
    offset whose rolled probe prediction best fits the probe read).  A
    stored bit is then chosen per dimension to minimize ``|pos_read(b) -
    c| + |neg_read(1 - b) - (1 - c)|``, ties keeping the content bit
    ``c``.  Ideal substrates return ``prototypes`` itself.  The three
    offset predictions are scored one at a time rather than stacked, the
    same sums in less memory.
    """
    if substrate.is_ideal:
        return prototypes
    pbits = bitops.unpack_bits(prototypes).to(torch.float32)    # (S, D)
    s, d = pbits.shape
    padded = pad_to_multiple(pbits, 0, xcfg.cols)
    pos_c = _to_row_tiles(padded, xcfg.rows)                    # (T, S_pad, R)
    neg_c = _to_row_tiles(1.0 - padded, xcfg.rows)
    del pbits, padded
    shape = tuple(pos_c.shape)
    probe = (draw_uniform(threefry.key(probe_seed), shape, pos_c.device,
                          substrate.partitionable) < 0.5).to(torch.float32)
    offsets = (-1, 0, 1)

    def transfer(stream: int):
        def readback(bits):
            return substrate.read_weights(
                substrate.program(bits, stream=stream), stream=stream)
        w0 = readback(torch.zeros(shape, device=pos_c.device))
        w1 = readback(torch.ones(shape, device=pos_c.device))
        wr = readback(probe)
        span = w1 - w0
        errs = []
        for k in offsets:
            pred = span * torch.roll(probe, k, dims=-1)
            errs.append(pred.add_(w0).sub_(wr).abs_().sum(dim=-1))
            del pred
        del span, wr
        pick = torch.stack(errs).argmin(dim=0)                  # (T, S_pad)
        k = torch.tensor(offsets, device=pos_c.device)[pick]
        # align the observed-position transfer back to stored positions:
        # stored bit i is read at observed position i + k
        return roll_tracks(w0, -k), roll_tracks(w1, -k), k

    p0, p1, k_pos = transfer(0)
    n0, n1, k_neg = transfer(1)
    # content targets at the observed (query-paired) positions
    c_pos = roll_tracks(pos_c, -k_pos)
    c_neg = roll_tracks(neg_c, -k_neg)
    err0 = (p0 - c_pos).abs_().add_((n1 - c_neg).abs_())   # store 0
    err1 = (p1 - c_pos).abs_().add_((n0 - c_neg).abs_())   # store 1
    del p0, p1, n0, n1, c_pos, c_neg
    chosen = torch.where(err1 < err0, 1.0,
                         torch.where(err0 < err1, 0.0, pos_c))
    flat = chosen.transpose(0, 1).reshape(shape[1], -1)[:s, :d]
    return bitops.pack_bits(flat.to(torch.uint8))


def crossbar_agreement(queries: torch.Tensor, prototypes: torch.Tensor,
                       dim: int, xcfg: CrossbarConfig, substrate: Substrate
                       ) -> torch.Tensor:
    """Full differential AM search: ``(B, W) x (S, W) -> (B, S)`` int32
    (program + one read; the substrate backends cache the programmed
    banks instead)."""
    b, s = queries.shape[0], prototypes.shape[0]
    state_pos, state_neg = program_prototypes(prototypes, xcfg, substrate)
    return crossbar_read(queries, state_pos, state_neg, dim, xcfg,
                         substrate)[:b, :s]
