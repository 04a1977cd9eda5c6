"""gemma3-27b [dense] — 62L d5376 32H (GQA kv=16) d_ff=21504 V=262144,
5:1 local:global attention, 128k context, QK-norm (no softcaps).
[hf:google/gemma-3-1b-pt; unverified]

62 layers = 10 full (local*5, global) periods + 2 remainder layers.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    window_pattern=("local",) * 5 + ("global",),
    window_size=1024,
    qk_norm=True,
    sandwich_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    loss_chunk=32_768,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=8,  # 1 full period + 2 remainder, keeps the rem path hot
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window_size=16, dtype="float32",
        loss_chunk=0)
