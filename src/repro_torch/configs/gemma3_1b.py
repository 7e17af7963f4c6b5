"""gemma3-1b — dense decoder with 5:1 local:global attention, 128k ctx.

[hf:google/gemma-3-1b-pt; unverified] 26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144, head_dim=256, sliding window 512 on local layers,
every 6th layer global.  long_500k runs: local layers are windowed
(sub-quadratic) and global layers are decode-linear.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    window=512,
    global_every=6,
    rope_theta=1_000_000.0,
    max_seq_len=131072,
    source="hf:google/gemma-3-1b-pt",
)
