"""Optimizer-side numerics: AdamW with an f32 master
(:mod:`repro_torch.optim.adamw`) and the blockwise int8 quantizer
(:mod:`repro_torch.optim.compression`) that the compressed wire uses."""
