"""phi3-mini-3.8b — dense decoder, RoPE/SwiGLU, MHA (GQA kv=32).

[arXiv:2404.14219; unverified] 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064.  Head dim 3072 / 32 = 96: the flash and decode kernels are
built for it.  About 3.82 B parameters, 7.64 GB in bf16: served whole on
one 80 GB card.  Pure full attention.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    rope_theta=10000.0,
    max_seq_len=131072,
    source="arXiv:2404.14219",
)
