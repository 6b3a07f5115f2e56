"""Checkpoints in ``repro``'s on-disk format, with async save (counterpart
of :mod:`repro.checkpoint`)."""
