"""Level-B model serving (PyTorch port of ``repro.serving``:
``ServingEngine`` and its components, ``EnginePool`` and the continuous
batcher)."""

from repro_torch.serving.components import (  # noqa: F401
    Component, ComponentRegistry, LoadPolicy,
)
from repro_torch.serving.engine import (  # noqa: F401
    EnginePool, PoolSaturated, ServingEngine,
)
from repro_torch.serving.batcher import ContinuousBatcher, Request  # noqa: F401
