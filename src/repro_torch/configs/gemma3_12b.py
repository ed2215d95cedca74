"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144; 5:1 local(1024-window):global attention, 128k context.
[hf:google/gemma-3-12b-pt]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec

WINDOW = 1024


def config() -> ArchConfig:
    local = LayerSpec(mixer="attn", mlp="dense", window=WINDOW)
    glob = LayerSpec(mixer="attn", mlp="dense", window=None)
    return ArchConfig(
        name="gemma3-12b",
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_ff=15360,
        vocab=262144,
        head_dim=256,
        super_block=(local, local, local, local, local, glob),
        n_repeats=8,  # 48 layers, 40 local + 8 global
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        # local layers dominate (5:1); global layers use the KV cache
        # linearly per decoded token -> long_500k eligible (DESIGN.md §5)
        subquadratic=True,
        max_seq_len=1_048_576,
    )


def smoke_config() -> ArchConfig:
    local = LayerSpec(mixer="attn", mlp="dense", window=16)
    glob = LayerSpec(mixer="attn", mlp="dense", window=None)
    return dataclasses.replace(
        config(), d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        head_dim=16, super_block=(local, local, glob), n_repeats=2,
        max_seq_len=128,
    )
