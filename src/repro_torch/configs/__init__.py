"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The JAX package's ten assigned architectures and its own demo config, in
its registry's order: the dense decoders (phi3-mini, smollm, gemma3's
local:global one, mistral-large), mixtral's sliding-window MoE and qwen3's
MoE, the Mamba2 SSM stack, zamba2's hybrid, llava-next's VLM and
seamless-m4t's encoder-decoder; each a copy of the JAX package's module of
the same name (exact published dims).
``get_smoke_config`` returns the reduced same-family variant used by CPU
smoke tests.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, smoke_variant

# arch-id -> module name
_REGISTRY: dict[str, str] = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "smollm-360m": "smollm_360m",
    "gemma3-1b": "gemma3_1b",
    "mistral-large-123b": "mistral_large_123b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
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
