"""Architecture registry: ``--arch <id>`` resolution for the LM path.

Counterpart of `repro/configs/registry.py` for the configs the port
runs: the dense family (nemotron-4-340b among it), the MoE family
(olmoe-1b-7b, and deepseek-v3-671b with MLA), the SSM family
(mamba2-780m) and the hybrid family (zamba2-2.7b).  The reference's other
architectures are known here and raise `NotImplementedError` naming the
ROADMAP item that ports them; an unknown id raises `KeyError`, as in
the reference.
"""
from __future__ import annotations

import importlib

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
}
# the reference's other architectures, by family
NOT_PORTED = {"whisper-tiny": "audio", "paligemma-3b": "vlm"}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} ({NOT_PORTED[arch]}) is not ported yet: "
            "ROADMAP.md Queue 1 item 16b (LM path: the rest)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULES) + sorted(NOT_PORTED)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))
