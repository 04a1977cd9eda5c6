"""Training (PyTorch port of ``repro.training``): AdamW, the train step,
checkpoints, int8 gradient compression, data and fault tolerance."""

from repro_torch.training.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.training.step import (  # noqa: F401
    make_serve_steps, make_train_step,
)
