"""qwen2.5-32b [dense] — 64L d5120 40H (GQA kv=8) d_ff=27648 V=152064,
QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    loss_chunk=32_768,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, dtype="float32", loss_chunk=0)
