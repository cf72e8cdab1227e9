"""Architecture registry: ``--arch <id>`` -> config (counterpart:
``repro/configs/registry.py``). Only the architectures the port runs are
listed; the others raise until their model family is ported."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "pimref-100m": "repro_torch.configs.pimref_100m",
}

ALL_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"arch {arch!r} not yet ported to repro_torch; "
                       f"ported: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
