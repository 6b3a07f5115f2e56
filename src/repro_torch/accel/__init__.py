"""Acc-Demeter device-model subsystem on torch (counterpart of
:mod:`repro.accel`, with the same public names).

* :mod:`~repro_torch.accel.substrate` -- the :class:`Substrate` protocol,
  the substrate registry and declared per-substrate options.
* :mod:`~repro_torch.accel.device` -- PCM cell physics
  (:class:`DeviceConfig`, :class:`PCMSubstrate`).
* :mod:`~repro_torch.accel.racetrack` -- domain-wall nanowire physics
  (:class:`RacetrackConfig`, :class:`RacetrackSubstrate`).
* :mod:`~repro_torch.accel.crossbar` -- differential tiling, bit-line
  accumulation (``torch.bmm`` over the row tiles), behavioral ADC.
* :mod:`~repro_torch.accel.backend_pcm` -- the ``pcm_sim`` and
  ``racetrack_sim`` backends.
* :mod:`~repro_torch.accel.cost` -- analytical latency / energy / area.
* :mod:`~repro_torch.accel.sweep` -- accuracy vs device knob.
* :mod:`~repro_torch.accel.codesign` -- the noise-aware RefDB.

Every draw is ``jax.random``'s (:mod:`repro_torch.core.threefry`; the
Threefry kernel :mod:`repro_torch.kernels.threefry` on the card).  What is
exact and what is near-exact against ``repro`` is stated in the README's
port section.
"""

from repro_torch.accel.substrate import (Substrate, available_substrates,
                                         narrowed_schema, register_substrate,
                                         resolve_substrate, substrate_options,
                                         union_schema)
from repro_torch.accel.device import (DeviceConfig, PCMSubstrate,
                                      program_conductances)
from repro_torch.accel.racetrack import RacetrackConfig, RacetrackSubstrate
from repro_torch.accel.crossbar import (CrossbarConfig, adc_quantize,
                                        crossbar_agreement,
                                        program_prototypes, write_verify_bits)
from repro_torch.accel.backend_pcm import (PCMBackend, PCMSimBackend,
                                           RacetrackSimBackend,
                                           SubstrateBackend, split_options)
from repro_torch.accel.cost import (DW_RACETRACK, UMC65_PCM, CostReport,
                                    PCMChip, RacetrackChip, accel_cost,
                                    racetrack_cost)
from repro_torch.accel.sweep import SWEEPABLE, SweepPoint, noise_sweep
from repro_torch.accel.codesign import noise_aware_refdb

__all__ = [
    "Substrate", "available_substrates", "narrowed_schema",
    "register_substrate", "resolve_substrate", "substrate_options",
    "union_schema",
    "DeviceConfig", "PCMSubstrate", "program_conductances",
    "RacetrackConfig", "RacetrackSubstrate",
    "CrossbarConfig", "adc_quantize", "crossbar_agreement",
    "program_prototypes", "write_verify_bits",
    "PCMBackend", "PCMSimBackend", "RacetrackSimBackend",
    "SubstrateBackend", "split_options",
    "DW_RACETRACK", "UMC65_PCM", "CostReport", "PCMChip", "RacetrackChip",
    "accel_cost", "racetrack_cost",
    "SWEEPABLE", "SweepPoint", "noise_sweep",
    "noise_aware_refdb",
]
