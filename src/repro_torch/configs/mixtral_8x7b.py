"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000; 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec, MoEConfig

WINDOW = 4096


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        head_dim=128,
        super_block=(LayerSpec(mixer="attn", mlp="moe", window=WINDOW),),
        n_repeats=32,
        moe=MoEConfig(n_experts=8, top_k=2),
        subquadratic=True,  # SWA: decode cost is O(window) per token
        max_seq_len=1_048_576,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        config(), d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        head_dim=16, n_repeats=2,
        super_block=(LayerSpec(mixer="attn", mlp="moe", window=16),),
        moe=MoEConfig(n_experts=4, top_k=2),
        max_seq_len=128,
    )
