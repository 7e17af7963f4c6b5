"""seamless-m4t-large-v2 — multimodal encoder-decoder backbone.

[arXiv:2308.11596; hf] 24L(enc)+24L(dec) d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206.  The speech frontend is a stub: precomputed frame
embeddings feed the encoder.  Decode runs against the self cache plus the
cross K/V computed once per request.  About 2.04 B parameters, 4.1 GB in
bf16.  Full attention.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,          # decoder depth
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    frontend="frames",
    rope_theta=10000.0,
    max_seq_len=8192,
    source="arXiv:2308.11596",
)
