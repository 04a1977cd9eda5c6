"""whisper-large-v3 [audio] — enc-dec, 32L decoder d1280 20H (kv=20)
d_ff=5120 V=51866, 32L encoder over 1500 audio frames.
[arXiv:2212.04356; unverified]

The conv audio frontend is a STUB per the assignment: ``input_specs``
feeds precomputed frame embeddings (B, 1500, d_model) into the
transformer encoder; every decoder block cross-attends to its output.
Decoder uses learned absolute positions (no RoPE) and QKV biases.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    qkv_bias=True,
    use_rope=False,
    learned_pos_embed=4096,
    encoder_layers=32,
    encoder_seq=1500,
    tie_embeddings=True,
    loss_chunk=65_536,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, learned_pos_embed=64, encoder_layers=2,
        encoder_seq=24, dtype="float32", loss_chunk=0)
