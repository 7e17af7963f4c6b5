"""Optimizer-side numerics; so far the blockwise int8 quantizer
(:mod:`repro_torch.optim.compression`) that the compressed wire uses."""
