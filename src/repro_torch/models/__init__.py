"""Dense-decoder subset of the model zoo (PyTorch port of ``repro.models``)."""

from repro_torch.models.config import (  # noqa: F401
    ArchConfig, MoEConfig, SHAPES, ShapeSpec, applicable_shapes,
)
from repro_torch.models.model import (  # noqa: F401
    block_pattern_of, decode_step, forward, init_cache, init_params,
    layer_layout, model_template, param_count, prefill,
)
