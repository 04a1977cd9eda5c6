"""recurrentgemma-2b [hybrid] — 26L d2560 10H (MQA kv=1) d_ff=7680
V=256000, RG-LRU + local attention at 1:2 (period: rglru, rglru, local).
[arXiv:2402.19427; hf]

Sub-quadratic: RG-LRU state + windowed attention -> runs long_500k.
26 layers = 8 full periods + 2 remainder (rglru, rglru).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rglru", "rglru", "attn_local"),
    window_size=2048,
    rglru_dim=2560,
    conv_width=4,
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    loss_chunk=32_768,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=5,  # 1 full period + 2 remainder
        d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, window_size=16, rglru_dim=64,
        dtype="float32", loss_chunk=0)
