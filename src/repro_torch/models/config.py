"""Copy of ``src/repro/models/config.py``: the architecture dataclasses.

Architecture configuration.

A model is a stack of *super-blocks*: one super-block is a short list of
heterogeneous layers (e.g. Jamba's 7 mamba + 1 attention) and the stack
holds ``n_repeats`` copies (an ``nn.ModuleList`` in the port, where the
reference scans over stacked parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128  # N
    head_dim: int = 64  # P
    n_groups: int = 1  # G (B/C sharing groups)
    conv_kernel: int = 4
    expand: int = 2  # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0  # 0 -> use cfg.d_ff
    # §Perf: pad the expert axis to a multiple of the TP degree so expert
    # parallelism shards cleanly (pad experts hold zero weight and are
    # never routed to).  0 = no padding.
    pad_experts_to: int = 0

    @property
    def storage_experts(self) -> int:
        return max(self.n_experts, self.pad_experts_to)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"  # attn | mamba | cross | none
    mlp: str = "dense"  # dense | moe | none
    window: Optional[int] = None  # sliding-window size for attn
    cross_memory: bool = False  # extra cross-attn sublayer (enc-dec decoder)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # stacking
    super_block: tuple[LayerSpec, ...] = (LayerSpec(),)
    n_repeats: int = 1
    # families
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None
    # enc-dec (seamless): encoder stack config
    n_encoder_layers: int = 0
    encoder_frontend_dim: int = 0  # stub frontend embedding dim (0 = text)
    # vision cross-attention (llama-3.2-vision): stub patch embeddings
    vision_tokens: int = 0
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 131_072
    # §Perf: int8 KV cache (per-token-per-head symmetric quantization);
    # halves decode cache reads/residency at <1e-2 logit error
    kv_cache_int8: bool = False
    # which shapes support sub-quadratic decode (long_500k eligibility)
    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return len(self.super_block) * self.n_repeats

    def layer_at(self, i: int) -> LayerSpec:
        return self.super_block[i % len(self.super_block)]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += D * V
        for spec in self.super_block:
            n = self.n_repeats
            if spec.mixer == "attn":
                if self.mla is not None:
                    m = self.mla
                    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += n * (
                        D * m.q_lora_rank
                        + m.q_lora_rank * self.n_heads * qh
                        + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank
                        * self.n_heads
                        * (m.qk_nope_head_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * D
                    )
                else:
                    hd = self.head_dim
                    total += n * (
                        D * self.n_heads * hd
                        + 2 * D * self.n_kv_heads * hd
                        + self.n_heads * hd * D
                    )
            elif spec.mixer == "cross":
                hd = self.head_dim
                total += n * (
                    D * self.n_heads * hd
                    + 2 * D * self.n_kv_heads * hd
                    + self.n_heads * hd * D
                )
            elif spec.mixer == "mamba":
                s = self.ssm
                d_in = s.expand * D
                H = d_in // s.head_dim
                conv_dim = d_in + 2 * s.n_groups * s.state_dim
                total += n * (
                    D * (2 * d_in + 2 * s.n_groups * s.state_dim + H)
                    + conv_dim * s.conv_kernel
                    + 3 * H
                    + d_in * D
                    + d_in  # gate norm
                )
            if spec.mlp == "dense":
                total += n * 3 * D * F
            elif spec.mlp == "moe":
                fe = self.moe.d_ff_expert or F
                total += n * (D * self.moe.n_experts + self.moe.n_experts * 3 * D * fe)
            total += n * 2 * D  # norms
        # encoder stack (enc-dec): attn + dense mlp + cross in decoder
        if self.n_encoder_layers:
            hd = self.head_dim
            total += self.n_encoder_layers * (
                D * self.n_heads * hd
                + 2 * D * self.n_kv_heads * hd
                + self.n_heads * hd * D
                + 3 * D * F
                + 2 * D
            )
        return total

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE uses top_k of n_experts."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        fe = self.moe.d_ff_expert or self.d_ff
        n_moe_layers = sum(
            self.n_repeats for s in self.super_block if s.mlp == "moe"
        )
        all_e = n_moe_layers * self.moe.n_experts * 3 * self.d_model * fe
        act_e = n_moe_layers * self.moe.top_k * 3 * self.d_model * fe
        return total - all_e + act_e


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
