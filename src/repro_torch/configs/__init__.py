"""LM architecture configs: the port's copy of ``repro.configs``."""
from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.configs.registry import ARCH_NAMES, all_configs, get_config

__all__ = ["ARCH_NAMES", "LMConfig", "ShapeSpec", "all_configs", "get_config"]
