"""qwen3-moe-30b-a3b — 128-expert top-8 fine-grained MoE.

[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (GQA kv=4) per-expert
d_ff=768 vocab=151936, head_dim=128.  About 30.5 B parameters, 61 GB in
bf16: served on one 80 GB card, each MoE layer through the no-drop sorted
dispatch.  Pure full attention.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768,
                  capacity_factor=1.25),
    rope_theta=1_000_000.0,
    max_seq_len=131072,
    source="hf:Qwen/Qwen3-30B-A3B",
)
