"""llava-next-mistral-7b — VLM: mistral-7b backbone + patch-embed stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000.  The anyres vision tower is a stub:
576 precomputed patch embeddings pass through a 2-layer projector and are
prepended to the text tokens.  About 7.27 B parameters, 14.5 GB in bf16:
served at full width on one 80 GB card.  Full attention (hf v1.6 config).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    frontend="patch",
    frontend_len=576,
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
