"""Data pipelines: the deterministic synthetic LM stream (counterpart of
:mod:`repro.data`)."""

from repro_torch.data.lm_data import DataConfig, batch_at

__all__ = ["DataConfig", "batch_at"]
