"""Architecture registry of the port (the dense configs it serves)."""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = ("granite-3-2b",)

_MODULES = {"granite-3-2b": "granite_3_2b"}


def arch_module(arch_id: str):
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    m = arch_module(arch_id)
    return m.SMOKE if smoke else m.CONFIG
