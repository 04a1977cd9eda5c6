"""Level-B model serving (PyTorch port of ``repro.serving``:
``ServingEngine`` and its components)."""

from repro_torch.serving.components import (  # noqa: F401
    Component, ComponentRegistry, LoadPolicy,
)
from repro_torch.serving.engine import ServingEngine  # noqa: F401
