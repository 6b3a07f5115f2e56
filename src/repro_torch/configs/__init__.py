"""Architecture registry: --arch <id> -> ModelConfig.

Counterpart of :mod:`repro.configs` (a copy).  Each module defines
``CONFIG`` (full assigned config) and ``SMOKE`` (reduced same-family
config for CPU tests).
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "deepseek_v2_lite",
    "phi35_moe",
    "starcoder2_7b",
    "deepseek_67b",
    "nemotron4_15b",
    "stablelm_3b",
    "whisper_tiny",
    "hymba_1_5b",
    "mamba2_1_3b",
    "paligemma_3b",
)

# External ids (assignment spelling) -> module names.
ALIASES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "starcoder2-7b": "starcoder2_7b",
    "deepseek-67b": "deepseek_67b",
    "nemotron-4-15b": "nemotron4_15b",
    "stablelm-3b": "stablelm_3b",
    "whisper-tiny": "whisper_tiny",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-1.3b": "mamba2_1_3b",
    "paligemma-3b": "paligemma_3b",
}


def get_config(arch: str, smoke: bool = False):
    name = ALIASES.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs() -> tuple[str, ...]:
    return ARCH_IDS
