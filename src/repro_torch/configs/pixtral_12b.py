"""pixtral-12b [vlm] — 40L d5120 32H (GQA kv=8) d_ff=14336 V=131072,
pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a STUB per the assignment: ``input_specs`` feeds
precomputed patch embeddings (B, vision_tokens, d_model) which fill the
first ``vision_tokens`` sequence positions through ``vision_proj``.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    vision_tokens=256,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    loss_chunk=32_768,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, vision_tokens=8, dtype="float32",
        loss_chunk=0)
