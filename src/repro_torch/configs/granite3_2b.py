"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155.  [hf:ibm-granite/granite-3.0-2b-base]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-3-2b",
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=49155,
        head_dim=64,
        super_block=(LayerSpec(mixer="attn", mlp="dense"),),
        n_repeats=40,
        tie_embeddings=True,
        max_seq_len=131_072,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        config(), d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        head_dim=16, n_repeats=2, max_seq_len=128,
    )
