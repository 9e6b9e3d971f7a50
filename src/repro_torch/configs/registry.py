"""Architecture registry: ``--arch <id>`` resolution for the LM path.

Counterpart of `repro/configs/registry.py`, every architecture of it:
the dense family (nemotron-4-340b among it), the MoE family (olmoe-1b-7b,
and deepseek-v3-671b with MLA), the SSM family (mamba2-780m), the hybrid
family (zamba2-2.7b), the audio family (whisper-tiny, an encoder-decoder)
and the vlm family (paligemma-3b, a prefix-LM).  An unknown id raises
`KeyError`, as in the reference.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, reduced

_MODULES = {
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
}
# the reference's architectures the port does not run: none left
NOT_PORTED: dict = {}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
