"""Assigned architecture registry.

Each module defines ``CONFIG`` (the exact assigned configuration) and
``reduced()`` (a small same-family config for CPU smoke tests).  Look
ups accept the public dashed ids (``--arch granite-moe-1b-a400m``).
"""

from importlib import import_module

ARCH_IDS = [
    "granite-moe-1b-a400m",
    "olmoe-1b-7b",
    "xlstm-350m",
    "qwen2.5-32b",
    "gemma2-9b",
    "gemma3-27b",
    "granite-8b",
    "pixtral-12b",
    "recurrentgemma-2b",
    "whisper-large-v3",
]


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _module(arch_id).reduced()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
