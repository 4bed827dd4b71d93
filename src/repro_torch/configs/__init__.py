"""Architecture configs: one module per assigned architecture.

Each module exports FULL (the published config, exact) and SMOKE (a
reduced same-family config for CPU tests). ``registry`` maps ids.
"""
from . import base
from .registry import ARCH_IDS, get_config, get_smoke, input_specs

__all__ = ["base", "ARCH_IDS", "get_config", "get_smoke", "input_specs"]
