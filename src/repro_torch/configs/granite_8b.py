"""granite-8b [dense] — 36L d4096 32H (GQA kv=8) d_ff=14336 V=49152,
llama-arch code model.  [arXiv:2405.04324; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=49152,
    tie_embeddings=True,
    rope_theta=10_000_000.0,
    loss_chunk=65_536,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, dtype="float32", loss_chunk=0)
