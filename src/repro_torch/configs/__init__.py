"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The dense decoders this package serves, each a copy of the JAX
package's module of the same name (exact published dims).
``get_smoke_config`` returns the reduced same-family variant used by CPU
smoke tests.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, smoke_variant

# arch-id -> module name
_REGISTRY: dict[str, str] = {
    "smollm-360m": "smollm_360m",
    "repro-100m": "repro_100m",
}


def list_archs() -> list[str]:
    return list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))
