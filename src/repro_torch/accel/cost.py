"""Analytical latency / energy / area models of the AM substrates (§6).

Counterpart of :mod:`repro.accel.cost`, copied: plain arithmetic whose
:class:`CostReport` fields equal ``repro``'s exactly.

Mirrors the :class:`benchmarks.hw.Chip` pattern: one frozen dataclass of
per-operation constants per substrate (the paper's 65nm UMC + PCM
technology point, and a racetrack/domain-wall point following the HDCR
design space — filled with literature values where the papers report
only aggregates; clearly *models*, not measurements) plus pure functions
that turn a workload shape into a Table-3-style breakdown.

The workload shape is exactly what the simulator in
:mod:`repro_torch.accel.crossbar` executes: a differential AM of
``2 * ceil(D/rows) * ceil(S/cols)`` arrays, one converter event per
(column, row tile, bank) per query, digital accumulation of partial
counts, and a CMOS n-gram encoder feeding the word lines.  The two cost
entries tell opposite stories through the same report shape:

* **PCM** (:func:`accel_cost`) — dense analog reads, but every bit-line
  current needs a 25 pJ SAR conversion, and multi-bit programming pays
  ``levels - 1`` program-and-verify pulses per cell;
* **racetrack** (:func:`racetrack_cost`) — transverse-read popcounts
  replace the ADC (sub-pJ sense amps, ~2 F^2 cells), but every access
  *shifts* whole tracks under their ports, so shift energy and serial
  shift latency dominate.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.accel.crossbar import CrossbarConfig


@dataclasses.dataclass(frozen=True)
class PCMChip:
    """65nm UMC + mushroom-cell PCM technology constants.

    Energy entries are per-event; area entries are per-instance.  The
    defaults follow the paper's synthesis point (65nm, ~1 GHz digital
    periphery) with Horowitz/Murmann-style literature numbers for the
    analog blocks.
    """

    freq_hz: float = 1.0e9          # digital periphery clock
    t_read_ns: float = 10.0         # crossbar row-activate + settle
    t_adc_ns: float = 5.0           # one SAR conversion
    t_set_ns: float = 100.0         # PCM SET/RESET programming pulse
    # energy
    fj_per_cell_read: float = 8.0   # V_read^2 * g_on * t_read (0.2 V)
    pj_per_adc: float = 25.0        # 8-9 bit SAR @ 65nm (Murmann FoM)
    pj_per_cell_set: float = 25.0   # one PCM program-and-verify pulse
    pj_per_dig_op: float = 0.5      # 32-bit add/popcount step @ 65nm
    pj_per_enc_bitop: float = 0.05  # 1-bit XOR/majority cell in the encoder
    # area
    f_nm: float = 65.0
    cell_area_f2: float = 25.0      # 1T1R PCM cell footprint
    adc_area_mm2: float = 0.003     # one SAR ADC instance
    dig_area_mm2_per_kgate: float = 0.0014
    encoder_kgates: float = 120.0   # n-gram bind/bundle/majority logic
    adcs_per_array: int = 8         # bit lines share ADCs (column-serial)
    row_activity: float = 0.5       # expected fraction of word lines high


UMC65_PCM = PCMChip()


@dataclasses.dataclass(frozen=True)
class RacetrackChip:
    """Domain-wall nanowire technology constants (HDCR-style point).

    A "cell" is one magnetic domain; a *track* holds ``rows`` of them and
    is accessed by shifting domains under ``ports`` access ports, where a
    transverse read (TR) senses the popcount of a ``tr_span``-domain
    segment directly — no per-bit-line ADC exists, which is the
    substrate's whole energy argument.
    """

    freq_hz: float = 1.0e9
    t_shift_ns: float = 0.5         # one domain step along a track
    t_tr_ns: float = 1.0            # one transverse-read sense
    t_write_ns: float = 2.0         # shift-register write, per domain
    # energy
    fj_per_cell_shift: float = 0.02  # moving one domain one position
    pj_per_tr: float = 0.5          # one TR sense event (vs a 25 pJ SAR)
    pj_per_cell_write: float = 0.1  # writing one domain
    pj_per_dig_op: float = 0.5
    pj_per_enc_bitop: float = 0.05
    # area
    f_nm: float = 65.0
    cell_area_f2: float = 2.0       # domain pitch; no access transistor
    sense_area_mm2: float = 0.0004  # one TR sense amplifier
    dig_area_mm2_per_kgate: float = 0.0014
    encoder_kgates: float = 120.0
    senses_per_array: int = 8       # tracks share TR sense amps


DW_RACETRACK = RacetrackChip()


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Per-query cost of one profiled read, plus one-time array costs.

    One report shape serves every substrate; ``substrate`` names the
    model that produced it and ``shift_pj`` is nonzero only where the
    access physics involves moving data under ports (racetrack).  For
    racetrack reports ``adc_pj`` carries the transverse-read sense
    energy — the TR sense amp *is* that substrate's converter.
    """

    # per-query energy, picojoules
    encoder_pj: float
    array_read_pj: float
    adc_pj: float
    digital_pj: float
    # per-query latency (pipelined steady state), nanoseconds
    latency_ns: float
    # one-time / static
    program_pj: float               # programming the whole AM once
    array_area_mm2: float
    adc_area_mm2: float
    encoder_area_mm2: float
    num_arrays: int
    substrate: str = "pcm"
    shift_pj: float = 0.0           # per-query track-shift energy

    @property
    def total_pj(self) -> float:
        return (self.encoder_pj + self.array_read_pj + self.adc_pj
                + self.digital_pj + self.shift_pj)

    @property
    def total_area_mm2(self) -> float:
        return self.array_area_mm2 + self.adc_area_mm2 + self.encoder_area_mm2

    @property
    def reads_per_s(self) -> float:
        return 1e9 / self.latency_ns

    def mbp_per_joule(self, read_len: int) -> float:
        """The paper's headline efficiency metric (megabasepairs/J)."""
        return read_len / (self.total_pj * 1e-12) / 1e6

    def energy_rows(self) -> list[tuple[str, float, float]]:
        """Table-3-style ``(component, pJ/read, percent)`` rows."""
        t = self.total_pj
        rows = [("encoder", self.encoder_pj),
                ("array_read", self.array_read_pj),
                ("adc", self.adc_pj),
                ("digital", self.digital_pj)]
        if self.shift_pj:
            rows.append(("shift", self.shift_pj))
        return [(n, e, 100.0 * e / t) for n, e in rows]


def accel_cost(num_protos: int, dim: int, read_len: int, ngram: int,
               xcfg: CrossbarConfig = CrossbarConfig(),
               chip: PCMChip = UMC65_PCM, levels: int = 2) -> CostReport:
    """PCM cost of one query against an ``S = num_protos`` prototype AM.

    Latency model: row tiles/arrays fire in parallel; each array's
    ``cols`` bit lines share ``adcs_per_array`` converters, so one AM
    read occupies ``t_read + ceil(cols / adcs) * t_adc``; the digital
    accumulation tree is pipelined behind the converters and the encoder
    is pipelined ahead of the search (the paper overlaps steps 3 and 4),
    so steady-state per-query latency is the AM read.

    ``levels`` is the cell's programmable-level count: the iterative
    program-and-verify loop needs one more verify step per extra level,
    so one-time programming energy scales with ``levels - 1`` (read
    energy does not — HD bits sit at the window extremes either way).
    """
    rt, ct = xcfg.num_tiles(dim, num_protos)
    num_arrays = xcfg.num_arrays(dim, num_protos)
    s_pad, d_pad = ct * xcfg.cols, rt * xcfg.rows
    cells = 2 * s_pad * d_pad                     # both differential banks

    # -- per-query energy ---------------------------------------------------
    grams = max(read_len - ngram + 1, 1)
    encoder_pj = grams * dim * chip.pj_per_enc_bitop \
        + dim * chip.pj_per_enc_bitop             # bind+bundle, + majority
    array_read_pj = cells * chip.row_activity * chip.fj_per_cell_read * 1e-3
    conversions = 2 * s_pad * rt                  # per (col, row tile, bank)
    adc_pj = conversions * chip.pj_per_adc
    digital_pj = conversions * chip.pj_per_dig_op  # partial-count adds

    # -- latency ------------------------------------------------------------
    latency_ns = chip.t_read_ns \
        + math.ceil(xcfg.cols / chip.adcs_per_array) * chip.t_adc_ns

    # -- one-time programming + area ---------------------------------------
    program_pj = cells * chip.pj_per_cell_set * (levels - 1)
    f_um = chip.f_nm * 1e-3
    cell_area_mm2 = chip.cell_area_f2 * (f_um * f_um) * 1e-6
    array_area_mm2 = cells * cell_area_mm2
    adc_area_mm2 = num_arrays * chip.adcs_per_array * chip.adc_area_mm2
    encoder_area_mm2 = chip.encoder_kgates * chip.dig_area_mm2_per_kgate

    return CostReport(
        encoder_pj=encoder_pj, array_read_pj=array_read_pj, adc_pj=adc_pj,
        digital_pj=digital_pj, latency_ns=latency_ns, program_pj=program_pj,
        array_area_mm2=array_area_mm2, adc_area_mm2=adc_area_mm2,
        encoder_area_mm2=encoder_area_mm2, num_arrays=num_arrays,
        substrate="pcm")


def racetrack_cost(num_protos: int, dim: int, read_len: int, ngram: int,
                   xcfg: CrossbarConfig = CrossbarConfig(),
                   chip: RacetrackChip = DW_RACETRACK,
                   ports: int = 4, tr_span: int = 5) -> CostReport:
    """Racetrack cost of one query against the same AM workload shape.

    One "array" is ``cols`` tracks of ``rows`` domains each.  Per query,
    every track aligns each ``tr_span``-domain segment under a port and
    senses it with one transverse read: ``ceil(rows / (tr_span * ports))``
    shift sequences of up to ``tr_span`` steps each — every domain passes
    a port once, so a track moves ``~rows / ports`` net positions — and
    ``ceil(rows / tr_span)`` TR senses.  Shifting one track one position
    moves all ``rows`` domains (that is racetrack's tax); sensing costs
    sub-pJ (that is its win over the SAR ADC).  Tracks shift in parallel,
    TR senses on a track serialize over its ports.
    """
    rt, ct = xcfg.num_tiles(dim, num_protos)
    num_arrays = xcfg.num_arrays(dim, num_protos)
    s_pad, d_pad = ct * xcfg.cols, rt * xcfg.rows
    cells = 2 * s_pad * d_pad                     # both differential banks
    tracks = cells // xcfg.rows                   # one track per (proto, tile)

    # -- per-query energy ---------------------------------------------------
    grams = max(read_len - ngram + 1, 1)
    encoder_pj = grams * dim * chip.pj_per_enc_bitop \
        + dim * chip.pj_per_enc_bitop
    shifts_per_track = math.ceil(xcfg.rows / ports)   # net domain steps
    shift_pj = tracks * shifts_per_track * xcfg.rows \
        * chip.fj_per_cell_shift * 1e-3
    tr_events = tracks * math.ceil(xcfg.rows / tr_span)
    adc_pj = tr_events * chip.pj_per_tr           # TR sense = the converter
    digital_pj = tr_events * chip.pj_per_dig_op   # partial-count adds
    array_read_pj = 0.0                           # folded into the TR sense

    # -- latency ------------------------------------------------------------
    latency_ns = shifts_per_track * chip.t_shift_ns \
        + math.ceil(xcfg.rows / (tr_span * ports)) * chip.t_tr_ns

    # -- one-time programming + area ---------------------------------------
    program_pj = cells * chip.pj_per_cell_write \
        + tracks * shifts_per_track * xcfg.rows * chip.fj_per_cell_shift * 1e-3
    f_um = chip.f_nm * 1e-3
    cell_area_mm2 = chip.cell_area_f2 * (f_um * f_um) * 1e-6
    array_area_mm2 = cells * cell_area_mm2
    adc_area_mm2 = num_arrays * chip.senses_per_array * chip.sense_area_mm2
    encoder_area_mm2 = chip.encoder_kgates * chip.dig_area_mm2_per_kgate

    return CostReport(
        encoder_pj=encoder_pj, array_read_pj=array_read_pj, adc_pj=adc_pj,
        digital_pj=digital_pj, latency_ns=latency_ns, program_pj=program_pj,
        array_area_mm2=array_area_mm2, adc_area_mm2=adc_area_mm2,
        encoder_area_mm2=encoder_area_mm2, num_arrays=num_arrays,
        substrate="racetrack", shift_pj=shift_pj)
