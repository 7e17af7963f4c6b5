from .sharding import (batch_axes_of, batch_specs, param_shardings,
                       param_specs, state_shardings)
from .collectives import compressed_psum, hierarchical_psum
from .pipeline import pipeline_forward

__all__ = ["batch_axes_of", "batch_specs", "param_shardings", "param_specs",
           "state_shardings", "compressed_psum", "hierarchical_psum",
           "pipeline_forward"]
