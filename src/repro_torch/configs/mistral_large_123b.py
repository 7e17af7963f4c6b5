"""mistral-large-123b — the largest assigned dense decoder.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified] 88L d_model=12288
96H (GQA kv=8) d_ff=28672 vocab=32768.  About 123 B parameters, 246 GB in
bf16: more than one 80 GB card holds, so the full depth needs a mesh of
several cards; one card serves it at published widths with the depth cut.
Pure full attention.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=32768,
    rope_theta=1_000_000.0,
    max_seq_len=131072,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
