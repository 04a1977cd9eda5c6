"""olmoe-1b-7b [moe] — 16L d2048 16H (kv=16) d_ff=1024 V=50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf]"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert_ff=1024),
    qk_norm=True,  # OLMoE uses QK-norm
    tie_embeddings=False,
    rope_theta=10_000.0,
    loss_chunk=65_536,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=32,
                      capacity_factor=8.0),  # dropless (see granite_moe)
        dtype="float32", loss_chunk=0)
