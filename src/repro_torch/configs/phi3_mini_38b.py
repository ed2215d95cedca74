"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064; RoPE + SwiGLU.  [arXiv:2404.14219]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-mini-3.8b",
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32064,
        head_dim=96,
        super_block=(LayerSpec(mixer="attn", mlp="dense"),),
        n_repeats=32,
        max_seq_len=131_072,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        config(), d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        head_dim=16, n_repeats=2, max_seq_len=128,
    )
