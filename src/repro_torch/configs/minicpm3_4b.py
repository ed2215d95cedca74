"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448;
multi-head latent attention (MLA).  [hf:openbmb/MiniCPM3-4B]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec, MLAConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b",
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab=73448,
        head_dim=96,  # qk_nope 64 + qk_rope 32
        super_block=(LayerSpec(mixer="attn", mlp="dense"),),
        n_repeats=62,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                      qk_rope_head_dim=32, v_head_dim=64),
        tie_embeddings=True,
        max_seq_len=32_768,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        config(), d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        head_dim=24, n_repeats=2,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        max_seq_len=128,
    )
