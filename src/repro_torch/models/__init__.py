"""Model zoo (PyTorch): the dense decoder of the JAX package's model zoo,
layer loop over an ``nn.ModuleList``, attention through the hand-written
kernels."""

from .api import ModelApi, build
from .blocks import ShardCtx
from .config import ModelConfig, MoEConfig, SSMConfig, smoke_variant

__all__ = ["ModelApi", "build", "ShardCtx", "ModelConfig", "MoEConfig",
           "SSMConfig", "smoke_variant"]
