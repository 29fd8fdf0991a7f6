"""Config registry of the port: only the index's own config so far."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import HMGIConfig, ShapeSpec

_MODULES = {
    "hmgi": "repro_torch.configs.hmgi",
}


def get_config(arch_id: str) -> HMGIConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)} (the model configs arrive with "
                       "ROADMAP Queue 1 items 16-17)")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_shapes(arch_id: str) -> List[ShapeSpec]:
    get_config(arch_id)
    return importlib.import_module(_MODULES[arch_id]).SHAPES
