"""seamless-m4t-large-v2 [audio] — enc-dec, d_model=1024 16H d_ff=8192
vocab=256206; 24 encoder + 24 decoder layers.  The modality frontend is a
STUB: input_specs() provides precomputed frame embeddings.
[arXiv:2308.11596]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2",
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256206,
        head_dim=64,
        super_block=(LayerSpec(mixer="attn", mlp="dense", cross_memory=True),),
        n_repeats=24,  # decoder
        n_encoder_layers=24,
        encoder_frontend_dim=1024,
        max_seq_len=32_768,
        subquadratic=False,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        config(), d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        head_dim=16, n_repeats=2, n_encoder_layers=2, encoder_frontend_dim=64,
        max_seq_len=128,
    )
