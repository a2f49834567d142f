"""Architecture configs: one module per assigned arch + registry (a copy of
``repro.configs``)."""
from .base import ArchConfig, SHAPES, get_config, list_archs, register

__all__ = ["ArchConfig", "SHAPES", "get_config", "list_archs", "register"]
