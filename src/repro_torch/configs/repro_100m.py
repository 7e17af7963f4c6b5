"""repro-100m — the framework's own demo config (examples/ end-to-end
run): a ~100M-parameter llama-style dense decoder sized so a few
hundred training steps complete on modest hardware while exercising the
full data path (basin-staged input pipeline, checkpointing, fidelity
accounting)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab=32000,
    rope_theta=10000.0,
    max_seq_len=2048,
    source="repro demo",
)
