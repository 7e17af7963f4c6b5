"""Model configuration — one dataclass covering every assigned family.

Families: ``dense`` (GQA transformer), ``moe`` (sparse FFN), ``ssm``
(Mamba2/SSD), ``hybrid`` (Mamba2 + shared attention block, Zamba2-style),
``encdec`` (encoder-decoder, Seamless-style), ``vlm`` (dense backbone +
patch-embedding frontend stub).

Per the assignment, [vlm]/[audio] entries specify the transformer backbone
only; the modality frontend is a stub whose precomputed embeddings arrive
via ``input_specs()``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int               # per-expert hidden width
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64             # Mamba2 P
    expand: int = 2                # d_inner = expand * d_model
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256               # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None             # default d_model // n_heads
    # attention pattern
    window: int = 0                            # 0 = full attention (SWA if > 0)
    global_every: int = 0                      # >0: every k-th layer is global (rest windowed)
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0                        # hybrid: shared attn block every k layers
    enc_layers: int = 0                        # encdec: encoder depth
    frontend: Optional[str] = None             # None | "patch" | "frames"
    frontend_len: int = 576                    # stub embedding length
    # numerics / misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "full"                        # none | dots | full
    max_seq_len: int = 131072
    source: str = ""                           # provenance note

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def d_inner(self) -> int:
        s = self.ssm or SSMConfig()
        return s.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        s = self.ssm or SSMConfig()
        return self.d_inner // s.head_dim

    @property
    def conv_dim(self) -> int:
        s = self.ssm or SSMConfig()
        return self.d_inner + 2 * s.n_groups * s.d_state

    @property
    def in_proj_dim(self) -> int:
        # Mamba2 fused in-projection: z, x, B, C, dt
        s = self.ssm or SSMConfig()
        return 2 * self.d_inner + 2 * s.n_groups * s.d_state + self.ssm_heads

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'attn' | 'moe' | 'mamba'."""
        if self.family in ("dense", "vlm"):
            return ["attn"] * self.n_layers
        if self.family == "moe":
            return ["moe"] * self.n_layers
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        if self.family == "hybrid":
            return ["mamba"] * self.n_layers  # shared attn woven in separately
        if self.family == "encdec":
            return ["attn"] * self.n_layers
        raise ValueError(self.family)

    def layer_windows(self) -> list[int]:
        """Per-layer attention window (0 = full).  Implements the paper
        configs' SWA / local:global interleavings."""
        if self.global_every > 0:
            # gemma3 pattern: (global_every-1) local layers then 1 global
            return [0 if (i + 1) % self.global_every == 0 else self.window
                    for i in range(self.n_layers)]
        return [self.window] * self.n_layers

    # -- parameter accounting (used by codesign + roofline useful-FLOPs) ----
    def param_count(self) -> int:
        D, V = self.d_model, self.vocab
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
        per_mlp = 3 * D * self.d_ff
        per_moe = (self.moe.n_experts * 3 * D * self.moe.d_ff_expert
                   + D * self.moe.n_experts) if self.moe else 0
        per_mamba = (D * self.in_proj_dim + self.conv_dim * (self.ssm.conv_width if self.ssm else 4)
                     + 3 * self.ssm_heads + self.d_inner + self.d_inner * D) if self.family in ("ssm", "hybrid") else 0
        total = emb
        if self.family in ("dense", "vlm"):
            total += self.n_layers * (per_attn + per_mlp + 2 * D)
        elif self.family == "moe":
            total += self.n_layers * (per_attn + per_moe + 2 * D)
        elif self.family == "ssm":
            total += self.n_layers * (per_mamba + 2 * D)
        elif self.family == "hybrid":
            total += self.n_layers * (per_mamba + 2 * D)
            total += per_attn + per_mlp + 2 * D  # one shared block
        elif self.family == "encdec":
            # encoder self-attn+mlp, decoder self+cross+mlp
            total += self.enc_layers * (per_attn + per_mlp + 2 * D)
            total += self.n_layers * (2 * per_attn + per_mlp + 3 * D)
        if self.frontend:
            total += 2 * D * D  # projector MLP
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active params (MoE activates top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        D = self.d_model
        dense_like = self.param_count() - self.n_layers * self.moe.n_experts * 3 * D * self.moe.d_ff_expert
        active_moe = self.n_layers * self.moe.top_k * 3 * D * self.moe.d_ff_expert
        return int(dense_like + active_moe)

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"), self.family
        if self.family not in ("ssm", "hybrid"):
            assert self.n_heads >= 1 and self.n_kv_heads >= 1
            assert self.n_heads % self.n_kv_heads == 0, "GQA group must divide"
        if self.family == "moe":
            assert self.moe is not None
        if self.family in ("ssm", "hybrid"):
            assert self.ssm is not None
            assert self.d_inner % (self.ssm.head_dim) == 0
        if self.family == "encdec":
            assert self.enc_layers > 0


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests: small depth/width,
    few experts, tiny vocab — per the assignment's smoke-test rule."""
    d_model = 64
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, n_heads // max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)))
    if n_heads % n_kv:
        n_kv = 1
    small: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=min(4, cfg.n_layers) if cfg.family != "hybrid" else 4,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab=256,
        max_seq_len=512,
        window=min(cfg.window, 32) if cfg.window else 0,
        global_every=cfg.global_every if cfg.global_every else 0,
        frontend_len=8 if cfg.frontend else cfg.frontend_len,
        remat="none",
    )
    if cfg.moe:
        small["moe"] = MoEConfig(n_experts=4, top_k=min(2, cfg.moe.top_k),
                                 d_ff_expert=64, capacity_factor=2.0)
    if cfg.ssm:
        small["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                                 n_groups=1, conv_width=4, chunk=16)
    if cfg.family == "hybrid":
        small["attn_every"] = 2
    if cfg.family == "encdec":
        small["enc_layers"] = 2
        small["n_layers"] = 2
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
