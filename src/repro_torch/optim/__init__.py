"""Optimizer-side numerics: AdamW with an f32 master
(:mod:`repro_torch.optim.adamw`), and the blockwise int8 quantizer with
error feedback (:mod:`repro_torch.optim.compression`), which the
compressed wire also uses."""
