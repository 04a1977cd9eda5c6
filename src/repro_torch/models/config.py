"""Architecture and shape configuration (PyTorch port of
``repro.models.config``).

One unified ``ArchConfig`` drives every assigned architecture; family-
specific behaviour is expressed through flags (MoE, window patterns,
softcaps, recurrence mix, frontends) so a single scan-over-layers
implementation covers the zoo.  ``ShapeSpec`` describes the assigned
input shapes (train_4k / prefill_32k / decode_32k / long_500k).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "vlm" | "audio"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2/3: 30.0
    rope_theta: float = 10_000.0
    use_rope: bool = True  # whisper: learned absolute positions instead
    # sliding-window pattern: period list of "local"/"global" (None = all
    # global).  gemma2: ("local","global"); gemma3: ("local",)*5+("global",)
    window_pattern: Optional[tuple[str, ...]] = None
    window_size: int = 4096
    # recurrence pattern for hybrid/ssm families: period list drawn from
    # {"rglru", "mlstm", "slstm", "attn_local"}; None = pure attention.
    block_pattern: Optional[tuple[str, ...]] = None
    rglru_dim: int = 0  # RG-LRU recurrence width (recurrentgemma: d_model)
    conv_width: int = 4  # temporal conv in recurrent blocks
    lru_heads: int = 0  # xLSTM heads for matrix memory
    # MoE
    moe: Optional[MoEConfig] = None
    # embeddings / head
    tie_embeddings: bool = True
    scale_embed: bool = False  # gemma family: embeddings * sqrt(d_model)
    learned_pos_embed: int = 0  # >0: learned absolute positions (whisper)
    # frontends (stubs fed by input_specs)
    encoder_layers: int = 0  # whisper encoder depth
    encoder_seq: int = 0  # whisper: 1500 frames
    vision_tokens: int = 0  # pixtral: patch tokens prepended
    # gemma2/3 sandwich norms (pre+post norm around attn and mlp)
    sandwich_norm: bool = False
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # remat policy for train: "none" | "block" (checkpoint each layer)
    remat: str = "block"
    # ---- execution knobs (perf-iteration surface, not architecture) ----
    scan_layers: bool = True  # scan over layer periods (small HLO)
    # kept for asdict parity with the reference, read nowhere: in the
    # port the tensor's device routes attention (CUDA -> hand-written
    # kernels, CPU -> their plain versions)
    attn_impl: str = "xla"  # "xla" | "pallas"
    # chunked (online-softmax) attention kicks in above this seq length;
    # bounds the transient fp32 score buffer to (chunk_q x chunk_kv) per
    # head — the XLA-path analogue of the Pallas flash kernel
    attn_chunk_threshold: int = 2_048
    attn_chunk_q: int = 1_024
    attn_chunk_kv: int = 1_024
    mlstm_chunk: int = 256  # chunkwise-parallel mLSTM chunk length
    # MoE dispatch group size: the Switch-style dispatch/combine einsums
    # cost O(tokens * E * C * D) with C ∝ group, so smaller groups cut
    # the one-hot dispatch overhead linearly (at some routing-balance
    # granularity loss)
    moe_group: int = 4096
    # KV-cache quantization for long-context decode ("int8" halves the
    # dominant HBM term; scales are per (token, kv-head))
    kv_quant: Optional[str] = None
    # skip writing unchanged cache slices back through the decode loop
    # (whisper's static cross-K/V); False reproduces the naive engine
    decode_skip_static_writes: bool = True
    # cross-entropy is computed in vocab-preserving token chunks of this
    # size (0 = unchunked); bounds the (tokens, vocab) logits buffer.
    loss_chunk: int = 0

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -------------------------------------------------------------- sizing
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        D, H, K, hd, F, V = (self.d_model, self.n_heads, self.n_kv_heads,
                             self.head_dim, self.d_ff, self.vocab)
        per_layer = D * hd * (H + 2 * K) + H * hd * D  # qkvo
        if self.moe:
            e = self.moe
            per_layer += D * e.n_experts + 3 * e.n_experts * D * e.d_expert_ff
        elif F > 0:
            per_layer += 3 * D * F  # gated mlp
        if self.block_pattern:
            # crude: recurrent blocks add ~4*D*rglru_dim
            per_layer += 2 * D * max(self.rglru_dim, D)
        total = self.n_layers * per_layer
        total += V * D * (1 if self.tie_embeddings else 2)
        total += self.encoder_layers * (4 * D * D + 3 * D * F)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        dense_like = self.param_count() - self.n_layers * (
            3 * e.n_experts * self.d_model * e.d_expert_ff)
        return int(dense_like + self.n_layers * 3 * e.top_k
                   * self.d_model * e.d_expert_ff)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve 500k contexts (no full-attention layer)?"""
        if self.block_pattern:
            return all(b in ("rglru", "mlstm", "slstm", "attn_local")
                       for b in self.block_pattern)
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The assigned shape cells for this arch (skips per DESIGN.md §4)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        names.append("long_500k")
    return names
