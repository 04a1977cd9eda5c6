"""gemma2-9b [dense] — 42L d3584 16H (GQA kv=8) d_ff=14336 V=256000,
local/global alternating attention, logit softcaps, sandwich norms.
[arXiv:2408.00118; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    window_pattern=("local", "global"),
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    loss_chunk=32_768,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window_size=16, dtype="float32",
        loss_chunk=0)
