"""Unified model API — one handle per architecture for the server, tests
and ``chip_smoke.py``.

``ModelApi`` exposes the training and serving entry points of the JAX
package's ``ModelApi``, dispatched per family (the enc-dec family to
:mod:`repro_torch.models.encdec`, the others to :mod:`repro_torch.models.lm`):

    init(seed, device, trainable)        -> params (an nn.Module)
    forward(params, tokens, ctx)         -> (logits, lb loss, z loss)
    loss(params, batch, ctx)             -> (scalar, aux dict)
    prefill(params, batch, ctx, max_len) -> (last logits, cache)
    init_cache(batch, max_len, ctx, device) -> cache dict
    decode_step(params, cache, tok, ctx) -> (logits, cache)

A batch holds ``tokens`` and, for a VLM, its stub patch embeddings
``extra_embeds``; for the enc-dec family its stub ``frames``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import encdec as encdec_lib
from . import lm as lm_lib
from .blocks import ShardCtx
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig

    @property
    def encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def init(self, seed: int = 0, *, device: torch.device | str,
             trainable: bool = False, keep=None
             ) -> lm_lib.LM | encdec_lib.EncDec:
        """Random parameters drawn on ``device`` from a generator seeded
        with ``seed`` (the same seed gives other numbers on another device
        type); ``trainable`` ones require gradients.  ``keep`` maps each
        parameter as it is drawn (``lm.init_lm``, ``encdec.init_encdec``)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        if self.encdec:
            return encdec_lib.init_encdec(self.cfg, generator=gen,
                                          device=device, trainable=trainable,
                                          keep=keep)
        return lm_lib.init_lm(self.cfg, generator=gen, device=device,
                              trainable=trainable, keep=keep)

    def forward(self, params, tokens: torch.Tensor, ctx: ShardCtx, *,
                extra_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.encdec:
            logits = encdec_lib.forward_encdec(params, self.cfg, frames,
                                               tokens, ctx)
            zero = torch.zeros((), dtype=torch.float32, device=logits.device)
            return logits, zero, zero
        return lm_lib.forward_lm(params, self.cfg, tokens, ctx,
                                 extra_embeds=extra_embeds)

    def loss(self, params, batch: dict, ctx: ShardCtx
             ) -> tuple[torch.Tensor, dict]:
        if self.encdec:
            return encdec_lib.encdec_loss(params, self.cfg, batch, ctx)
        return lm_lib.lm_loss(params, self.cfg, batch, ctx)

    def prefill(self, params, batch: dict, ctx: ShardCtx,
                max_len: int) -> tuple[torch.Tensor, dict]:
        if self.encdec:
            return encdec_lib.prefill_encdec(params, self.cfg, batch, ctx,
                                             max_len)
        return lm_lib.prefill_lm(params, self.cfg, batch["tokens"], ctx,
                                 max_len,
                                 extra_embeds=batch.get("extra_embeds"))

    def init_cache(self, batch: int, max_len: int,
                   ctx: Optional[ShardCtx] = None, *,
                   device: torch.device | str,
                   enc_len: Optional[int] = None) -> dict:
        if self.encdec:
            return encdec_lib.init_encdec_cache(
                self.cfg, batch, max_len, enc_len or max_len, ctx,
                device=device)
        return lm_lib.init_lm_cache(self.cfg, batch, max_len, ctx,
                                    device=device)

    def decode_step(self, params, cache: dict, tokens: torch.Tensor,
                    ctx: ShardCtx) -> tuple[torch.Tensor, dict]:
        if self.encdec:
            return encdec_lib.encdec_decode_step(params, self.cfg, cache,
                                                 tokens, ctx)
        return lm_lib.lm_decode_step(params, self.cfg, cache, tokens, ctx)


def build(cfg: ModelConfig) -> ModelApi:
    cfg.validate()
    return ModelApi(cfg)
