"""smollm-360m — llama-arch small dense decoder.

[hf:HuggingFaceTB/SmolLM-135M; hf] 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152.  15 heads do not divide the 16-wide model axis:
attention activations stay data-sharded (weights still column-shard);
the chunked-attention path bounds the score workspace.  Pure full
attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    rope_theta=10000.0,
    max_seq_len=8192,
    source="hf:HuggingFaceTB/SmolLM-360M",
)
