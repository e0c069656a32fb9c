"""Architecture registry of the port: the ``--arch`` ids it has so far
(``repro/configs/__init__.py`` lists all ten).  Serving runs the llama
family and gemma2 (the engine refuses the encoder-decoder); training runs
smollm-135m, llama3.2-1b and whisper-small (``launch/train.py``)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "smollm-135m": "smollm_135m",
    "llama3.2-1b": "llama3_2_1b",
    "gemma2-2b": "gemma2_2b",
    "whisper-small": "whisper_small",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced()
