"""The training-input pipeline (:mod:`repro_torch.data.pipeline`)."""

from .pipeline import (FileTokenSource, InputPipeline, PipelineConfig,
                       SyntheticTokenSource)

__all__ = ["FileTokenSource", "InputPipeline", "PipelineConfig",
           "SyntheticTokenSource"]
