"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8)
d_ff(expert)=512 vocab=49155; MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-3b-a800m-base]"""
import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab=49155,
        head_dim=64,
        super_block=(LayerSpec(mixer="attn", mlp="moe"),),
        n_repeats=32,
        # §Perf hillclimb 1: pad 40 experts -> 48 (multiple of the 16-way
        # model axis) so expert parallelism shards cleanly; without this the
        # expert weights fall back to TP sharding with an (B,S,E,F) partial-
        # sum all-reduce per MoE layer (see EXPERIMENTS.md §Perf).
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                      pad_experts_to=48),
        tie_embeddings=True,
        max_seq_len=131_072,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        config(), d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
        head_dim=16, n_repeats=2,
        moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=64),
        max_seq_len=128,
    )
