"""Unified model API — one handle per architecture for the server, tests
and ``chip_smoke.py``.

``ModelApi`` exposes the serving entry points of the JAX package's
``ModelApi``:

    init(seed, device)                   -> params (an nn.Module)
    prefill(params, batch, ctx, max_len) -> (last logits, cache)
    init_cache(batch, max_len, ctx, device) -> cache dict
    decode_step(params, cache, tok, ctx) -> (logits, cache)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import lm as lm_lib
from .blocks import ShardCtx
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig

    def init(self, seed: int = 0, *,
             device: torch.device | str) -> lm_lib.LM:
        """Random parameters drawn on ``device`` from a generator seeded
        with ``seed`` (the same seed gives other numbers on another device
        type)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return lm_lib.init_lm(self.cfg, generator=gen, device=device)

    def prefill(self, params: lm_lib.LM, batch: dict, ctx: ShardCtx,
                max_len: int) -> tuple[torch.Tensor, dict]:
        return lm_lib.prefill_lm(params, self.cfg, batch["tokens"], ctx,
                                 max_len)

    def init_cache(self, batch: int, max_len: int,
                   ctx: Optional[ShardCtx] = None, *,
                   device: torch.device | str) -> dict:
        return lm_lib.init_lm_cache(self.cfg, batch, max_len, ctx,
                                    device=device)

    def decode_step(self, params: lm_lib.LM, cache: dict,
                    tokens: torch.Tensor, ctx: ShardCtx
                    ) -> tuple[torch.Tensor, dict]:
        return lm_lib.lm_decode_step(params, self.cfg, cache, tokens, ctx)


def build(cfg: ModelConfig) -> ModelApi:
    cfg.validate()
    return ModelApi(cfg)
