"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
(per expert) vocab=32768, window 4096 (per assignment).  Every layer is
windowed, so the decode cache is a ring of min(4096, max_len) slots.
About 141 B parameters, 282 GB in bf16: more than one 80 GB card holds,
so the full depth needs a mesh of several cards (``Server(cfg, mesh)``);
one card serves it at published widths with the depth cut.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384,
                  capacity_factor=1.25),
    rope_theta=1_000_000.0,
    max_seq_len=524288,
    source="arXiv:2401.04088",
)
