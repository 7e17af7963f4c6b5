"""mamba2-1.3b — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified] 48L d_model=2048 vocab=50280,
ssm_state=128, headdim=64, expand=2 (d_inner=4096, 64 SSD heads).
long_500k runs: decode state is O(1) in sequence length.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # attention-free; placeholders
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=256),
    max_seq_len=1_048_576,
    source="arXiv:2405.21060",
)
