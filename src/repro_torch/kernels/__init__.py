"""Hand-written CUDA kernels for the serving hot spots (Hopper, sm_90a).

Each kernel ships as ``csrc/<name>.cu`` (CUDA C++ with a plain C entry
point, built by ``_build`` with nvcc at first use and loaded with
ctypes), a wrapper in ``<name>.py`` that launches it on CUDA tensors and
runs its plain PyTorch version on CPU tensors, and model-layout wrappers
in ``ops.py``.
"""

from repro_torch.kernels.decode_attention import decode_attention  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: F401
