"""mamba2-370m [ssm] — 48L d_model=1024, attention-free SSD blocks,
vocab=50280, ssm_state=128.  [arXiv:2405.21060]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m",
        d_model=1024,
        n_heads=32,       # SSD heads (d_inner=2048 / head_dim=64)
        n_kv_heads=32,
        d_ff=0,           # attention-free, no MLP (pure Mamba-2 blocks)
        vocab=50280,
        head_dim=64,
        super_block=(LayerSpec(mixer="mamba", mlp="none"),),
        n_repeats=48,
        ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=1, conv_kernel=4,
                      expand=2),
        tie_embeddings=True,
        subquadratic=True,
        max_seq_len=1_048_576,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        config(),
        d_model=64,
        n_heads=8,
        n_kv_heads=8,
        vocab=128,
        head_dim=16,
        n_repeats=2,
        ssm=SSMConfig(state_dim=16, head_dim=16, n_groups=1, conv_kernel=4,
                      expand=2),
        max_seq_len=128,
    )
