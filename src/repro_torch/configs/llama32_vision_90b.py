"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attention image layers every 5th layer.
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings.  [hf:meta-llama/Llama-3.2-90B-Vision]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    attn = LayerSpec(mixer="attn", mlp="dense")
    cross = LayerSpec(mixer="cross", mlp="dense")
    return ArchConfig(
        name="llama-3.2-vision-90b",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        head_dim=128,
        super_block=(attn, attn, attn, attn, cross),
        n_repeats=20,  # 100 layers total, 20 cross
        vision_tokens=1601,
        rope_theta=500_000.0,
        max_seq_len=131_072,
        subquadratic=False,  # full attention -> long_500k skipped
    )


def smoke_config() -> ArchConfig:
    c = config()
    return dataclasses.replace(
        c,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=128,
        head_dim=16,
        n_repeats=1,
        vision_tokens=8,
        max_seq_len=128,
    )
