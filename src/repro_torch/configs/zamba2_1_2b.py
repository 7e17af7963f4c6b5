"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64.  One shared transformer block (attn+MLP) is
applied every 6 Mamba2 layers, reusing the same weights at each site
(the Zamba2 parameter-sharing trick).  long_500k runs (SSM state is O(1);
the shared block uses a 4096 ring window at long context).
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=256),
    attn_every=6,
    window=4096,     # ring window for the shared attention block
    rope_theta=10000.0,
    max_seq_len=524288,
    source="arXiv:2411.15242",
)
