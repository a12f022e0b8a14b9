"""--arch registry: name -> (FULL config, SMOKE config)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LMConfig
from repro_torch.configs import (grok_1_314b, deepseek_v3_671b, seamless_m4t_medium,
                           granite_8b, qwen2_0_5b, minitron_8b, granite_3_2b,
                           falcon_mamba_7b, zamba2_1_2b, internvl2_26b)

_MODULES = {
    "grok-1-314b": grok_1_314b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "granite-8b": granite_8b,
    "qwen2-0.5b": qwen2_0_5b,
    "minitron-8b": minitron_8b,
    "granite-3-2b": granite_3_2b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "zamba2-1.2b": zamba2_1_2b,
    "internvl2-26b": internvl2_26b,
}

ARCH_NAMES = tuple(_MODULES.keys())


def get_config(name: str, smoke: bool = False) -> LMConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    m = _MODULES[name]
    return m.SMOKE if smoke else m.FULL


def all_configs(smoke: bool = False) -> Dict[str, LMConfig]:
    return {n: get_config(n, smoke) for n in ARCH_NAMES}
