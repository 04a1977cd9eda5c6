"""granite-moe-1b-a400m [moe] — 24L d1024 16H (kv=8) d_ff=512 V=49155,
MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert_ff=512),
    tie_embeddings=True,
    rope_theta=10_000.0,
    loss_chunk=65_536,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=256,
        # capacity 8.0: dropless in smoke tests so batched prefill and
        # per-token decode dispatch identically (capacity ordering is the
        # only nondeterminism between the two paths)
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=32,
                      capacity_factor=8.0),
        dtype="float32", loss_chunk=0)
