"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536; Mamba+attention 1:7 interleave, MoE 16 experts
top-2 on alternate layers.  [arXiv:2403.19887]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec, MoEConfig, SSMConfig


def _sb():
    # 8-layer super-block: attention at index 3 (1:7), MoE every other layer
    layers = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        layers.append(LayerSpec(mixer=mixer, mlp=mlp))
    return tuple(layers)


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65536,
        head_dim=128,
        super_block=_sb(),
        n_repeats=9,  # 72 layers
        moe=MoEConfig(n_experts=16, top_k=2),
        ssm=SSMConfig(state_dim=128, head_dim=128, n_groups=8, conv_kernel=4,
                      expand=2),
        subquadratic=True,
        max_seq_len=262_144,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        config(),
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=128,
        head_dim=16,
        n_repeats=1,
        moe=MoEConfig(n_experts=4, top_k=2),
        ssm=SSMConfig(state_dim=16, head_dim=16, n_groups=2, conv_kernel=4,
                      expand=2),
        max_seq_len=128,
    )
