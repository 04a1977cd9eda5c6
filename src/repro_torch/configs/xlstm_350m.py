"""xlstm-350m [ssm] — 24L d1024 4H (kv=4) d_ff=0 V=50304,
alternating mLSTM / sLSTM blocks.  [arXiv:2405.04517; unverified]

Sub-quadratic: constant-size recurrent state -> runs long_500k.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,  # xLSTM blocks carry their own projections; no separate MLP
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    lru_heads=4,
    tie_embeddings=True,
    loss_chunk=65_536,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        lru_heads=4, vocab=256, dtype="float32", loss_chunk=0)
