"""Plain PyTorch versions of the kernels under the reference's oracle
names (``repro.kernels.ref``): the correctness contract the kernels are
held to."""

from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention_plain as ref_decode_attention,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_plain as ref_flash_attention,
)
from repro_torch.kernels.rglru_scan import (  # noqa: F401
    rglru_scan_plain as ref_rglru_scan,
)
