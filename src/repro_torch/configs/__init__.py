"""Architecture registry of the port: the configs it serves (every
family) and trains (the dense ones)."""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = ("rwkv6-3b", "qwen3-4b", "minitron-8b", "granite-3-2b",
            "internvl2-2b", "zamba2-1.2b", "moonshot-v1-16b-a3b",
            "llama4-maverick-400b-a17b", "seamless-m4t-large-v2")

_MODULES = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-4b": "qwen3_4b",
    "minitron-8b": "minitron_8b",
    "granite-3-2b": "granite_3_2b",
    "internvl2-2b": "internvl2_2b",
    "zamba2-1.2b": "zamba2_1_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def arch_module(arch_id: str):
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    m = arch_module(arch_id)
    return m.SMOKE if smoke else m.CONFIG
