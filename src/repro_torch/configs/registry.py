"""Architecture registry: ``--arch <id>`` -> config (counterpart:
``repro/configs/registry.py``). Every architecture of the reference is
listed: the dense, MoE, VLM, hybrid (Griffin), ssm (xLSTM) and audio
(encoder-decoder) families."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "pimref-100m": "repro_torch.configs.pimref_100m",
}

ALL_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
