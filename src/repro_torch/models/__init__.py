"""Model zoo (PyTorch): the JAX package's decoders (dense, VLM, MoE, SSM,
hybrid) and its encoder-decoder, each layer stack an ``nn.ModuleList``
walked by a loop, attention and the SSD scan through the hand-written
kernels."""

from .api import ModelApi, build
from .blocks import ShardCtx
from .config import ModelConfig, MoEConfig, SSMConfig, smoke_variant

__all__ = ["ModelApi", "build", "ShardCtx", "ModelConfig", "MoEConfig",
           "SSMConfig", "smoke_variant"]
