"""GQA self-attention (full and sliding-window): a port of
``src/repro/models/attention.py:16-123`` — ``init_attention``, the
sequence form ``attention_seq`` (train / prefill, through the
flash_attention kernel), the int8 KV-cache codec and the single-token
``attention_decode`` (plain torch, as the reference uses no kernel there,
``:112-120``), including the sliding-window ring buffer.

Multi-head latent attention (MLA, ``:127-241``): ``init_mla``, the
sequence form ``mla_seq`` (through the flash_attention kernel, v
zero-padded to q's head dim) and ``mla_decode`` against the compressed
latent cache (plain torch, as the reference).

Cross-attention (``:245-279``): ``init_cross_attention`` (the attention's
leaves and a 0-d ``gate``), ``cross_memory`` (k and v from the memory,
once a sequence) and ``cross_attention`` (through the flash_attention
kernel without the causal mask, in prefill and in decode).

``params`` is anything indexable by the reference's keys (a dict of
tensors, or the port's :class:`repro_torch.models.transformer.Params`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dense_init, apply_rope, init_rmsnorm, rmsnorm


def init_attention(generator, cfg: ArchConfig, device=None):
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _dense_init(generator, (D, H * hd), device=device),
        "wk": _dense_init(generator, (D, Hkv * hd), device=device),
        "wv": _dense_init(generator, (D, Hkv * hd), device=device),
        "wo": _dense_init(generator, (H * hd, D), scale=(H * hd) ** -0.5,
                          device=device),
    }


def attention_seq(params, x, cfg: ArchConfig, *, window=None, positions=None,
                  q_offset: int = 0, causal: bool = True):
    """Sequence-form attention (train / prefill).  Returns (out, (k, v))
    with k, v (B, Hkv, S, hd) in the activations' dtype."""
    B, S, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    if positions is None:
        positions = q_offset + torch.arange(S, device=x.device)[None, :]
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ params["wk"].to(dt)).reshape(B, S, Hkv, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, S, Hkv, hd)
    q = apply_rope(q.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    v = v.transpose(1, 2).contiguous()  # (B, Hkv, S, hd)
    o = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return o @ params["wo"].to(dt), (k, v)


def quantize_kv(x):
    """Per-(batch, head, position) symmetric int8 over the head dim.
    x: (..., hd) -> (int8 (..., hd), float32 scale (...)).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def attention_decode(params, x, cache, pos: int, cfg: ArchConfig, *,
                     window=None):
    """Single-token decode.  cache: (k, v) each (B, Hkv, S_cache, hd), or
    the int8 form (kq, ks, vq, vs) when ``cfg.kv_cache_int8``; ``pos``:
    the current position (a Python int).  Returns (out, new_cache); the
    cache tensors are updated in place (the reference returns new arrays).

    For windowed layers the cache is a ring buffer of size ``window``."""
    B, _, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    int8_cache = len(cache) == 4
    if int8_cache:
        k_cache, k_scale, v_cache, v_scale = cache
    else:
        k_cache, v_cache = cache
    S_cache = k_cache.shape[2]

    q = (x @ params["wq"].to(dt)).reshape(B, 1, H, hd)
    k = (x @ params["wk"].to(dt)).reshape(B, 1, Hkv, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, 1, Hkv, hd)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q.transpose(1, 2), posv[:, None, :], cfg.rope_theta)  # (B,H,1,hd)
    k = apply_rope(k.transpose(1, 2), posv[:, None, :], cfg.rope_theta)
    v = v.transpose(1, 2)

    # floor modulo, as jnp's % on a non-negative position; past the end of
    # a full cache the write lands on the last slot, as
    # dynamic_update_slice clamps its start
    slot = pos % S_cache if window is not None else min(pos, S_cache - 1)
    if int8_cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_cache[:, :, slot:slot + 1] = kq
        v_cache[:, :, slot:slot + 1] = vq
        k_scale[:, :, slot:slot + 1] = ks
        v_scale[:, :, slot:slot + 1] = vs
        k_full = dequantize_kv(k_cache, k_scale, torch.float32)
        v_full = dequantize_kv(v_cache, v_scale, torch.float32)
        new_cache = (k_cache, k_scale, v_cache, v_scale)
    else:
        k_cache[:, :, slot:slot + 1] = k
        v_cache[:, :, slot:slot + 1] = v
        k_full, v_full = k_cache, v_cache
        new_cache = (k_cache, v_cache)

    # positions of cache slots (ring-aware) for masking
    idx = torch.arange(S_cache, device=x.device)
    if window is not None:
        wrap = (pos // S_cache) * S_cache
        slot_pos = torch.where(idx <= slot, wrap + idx, wrap - S_cache + idx)
        valid = (slot_pos >= max(0, pos - window + 1)) & (slot_pos <= pos)
    else:
        valid = idx <= pos

    # query head h reads KV head h // n_rep: the reference's jnp.repeat,
    # written as a grouped product instead of a copy of the cache
    n_rep = H // Hkv
    qg = q.float().reshape(B, Hkv, n_rep, hd)
    s = torch.einsum("bgrd,bgkd->bgrk", qg, k_full.float()) * (hd ** -0.5)
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bgkd->bgrd", p, v_full.float()).to(dt)
    o = o.reshape(B, 1, H * hd)
    return o @ params["wo"].to(dt), new_cache


# ------------------------------------------------------------------ MLA
def init_mla(generator, cfg: ArchConfig, device=None):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": _dense_init(generator, (D, m.q_lora_rank), device=device),
        "q_norm": init_rmsnorm(m.q_lora_rank, device),
        "w_uq": _dense_init(generator, (m.q_lora_rank, H * qh), device=device),
        "w_dkv": _dense_init(generator, (D, m.kv_lora_rank + m.qk_rope_head_dim),
                             device=device),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, device),
        "w_ukv": _dense_init(generator, (m.kv_lora_rank,
                                         H * (m.qk_nope_head_dim + m.v_head_dim)),
                             device=device),
        "wo": _dense_init(generator, (H * m.v_head_dim, D), device=device),
    }


def _mla_query(params, x, cfg: ArchConfig, positions):
    """(q_nope (B, H, S, nope), roped q_rope (B, H, S, rope)) for x (B, S, D)."""
    m = cfg.mla
    B, S, _ = x.shape
    dt = x.dtype
    cq = rmsnorm(x @ params["w_dq"].to(dt), params["q_norm"], cfg.norm_eps)
    q = (cq @ params["w_uq"].to(dt)).reshape(
        B, S, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim).transpose(1, 2)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)


def _mla_expand(params, latent, cfg: ArchConfig, positions):
    """The latent (B, S, kv_rank + rope) up-projected: k_nope and v
    (B, S, H, nope) and (B, S, H, v), and the roped k_rope (B, 1, S, rope)
    that every head shares."""
    m = cfg.mla
    B, S, _ = latent.shape
    c_kv, k_rope = latent.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(c_kv, params["kv_norm"], cfg.norm_eps)
    kv = (c_kv @ params["w_ukv"].to(latent.dtype)).reshape(
        B, S, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, None], positions[:, None, :], cfg.rope_theta)
    return k_nope, v, k_rope


def mla_seq(params, x, cfg: ArchConfig, *, q_offset: int = 0):
    """Multi-head latent attention, sequence form.  The cache is the
    compressed latent (B, S, kv_rank + rope_dim), pre-norm and pre-rope in
    the activations' dtype.  Returns (out, latent)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    dt = x.dtype
    positions = q_offset + torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_query(params, x, cfg, positions)
    latent = x @ params["w_dkv"].to(dt)
    k_nope, v, k_rope = _mla_expand(params, latent, cfg, positions)

    q_full = torch.cat([q_nope, q_rope], dim=-1)  # (B, H, S, qk)
    # k_rope broadcast over the heads, written out: the kernel takes a
    # contiguous k, never a stride-0 head axis
    k_full = torch.cat([k_nope.transpose(1, 2),
                        k_rope.expand(B, H, S, m.qk_rope_head_dim)], dim=-1)
    # v's head dim may differ from q's and k's: zero-padded for the
    # kernel, the output sliced back (the scale stays q's D ** -0.5)
    v_p = F.pad(v.transpose(1, 2), (0, q_full.shape[-1] - m.v_head_dim))
    o = flash_attention(q_full, k_full, v_p, causal=True, q_offset=q_offset)
    o = o[..., :m.v_head_dim].transpose(1, 2).reshape(B, S, H * m.v_head_dim)
    return o @ params["wo"].to(dt), latent


def mla_decode(params, x, latent_cache, pos: int, cfg: ArchConfig):
    """Single-token MLA decode against the compressed latent cache
    (B, S_cache, kv_rank + rope_dim): the new latent written at ``pos``
    in place (past the end, on the last slot, as dynamic_update_slice
    clamps its start), then the whole cache normalised, up-projected and
    roped at positions 0..S_cache-1, the slots past ``pos`` masked.
    Returns (out, latent_cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    dt = x.dtype
    S_cache = latent_cache.shape[1]
    slot = min(pos, S_cache - 1)
    latent_cache[:, slot:slot + 1] = x @ params["w_dkv"].to(dt)
    positions = torch.arange(S_cache, device=x.device)[None, :]

    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_query(params, x, cfg, posv)  # (B, H, 1, .)
    k_nope, v, k_rope = _mla_expand(params, latent_cache, cfg, positions)

    s = (torch.einsum("bhqd,bshd->bhqs", q_nope.float(), k_nope.float())
         + torch.einsum("bhqd,bsd->bhqs", q_rope.float(), k_rope[:, 0].float())
         ) * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    valid = torch.arange(S_cache, device=x.device) <= pos
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bshd->bhqd", p, v.float()).to(dt)
    o = o.transpose(1, 2).reshape(B, 1, H * m.v_head_dim)
    return o @ params["wo"].to(dt), latent_cache


# ------------------------------------------------------------ cross-attn
def init_cross_attention(generator, cfg: ArchConfig, device=None):
    """The attention's leaves and a 0-d float32 ``gate``, zero as drawn: a
    fresh cross-attention adds nothing to the residual (tanh(0) = 0)."""
    p = init_attention(generator, cfg, device)
    p["gate"] = torch.zeros((), dtype=torch.float32, device=device or generator.device)
    return p


def cross_attention(params, x, memory_kv, cfg: ArchConfig):
    """x (B, S, D) attends to a fixed memory (vision patches or the
    encoder's output) through the flash_attention kernel without the
    causal mask, in prefill (S tokens) and in decode (one).  memory_kv:
    (k, v) each (B, Hkv, M, hd), from :func:`cross_memory`."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, hd).transpose(1, 2)
    k, v = memory_kv
    o = flash_attention(q, k.to(dt), v.to(dt), causal=False)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return torch.tanh(params["gate"]).to(dt) * (o @ params["wo"].to(dt))


def cross_memory(params, memory, cfg: ArchConfig):
    """Cross-attention's (k, v), each (B, Hkv, M, hd) in the memory's
    dtype and without rope, from memory embeddings (B, M, D): computed
    once a sequence, in prefill."""
    B, M, D = memory.shape
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    dt = memory.dtype
    k = (memory @ params["wk"].to(dt)).reshape(B, M, Hkv, hd).transpose(1, 2)
    v = (memory @ params["wv"].to(dt)).reshape(B, M, Hkv, hd).transpose(1, 2)
    # laid out once here, not copied again by every decode step's kernel call
    return k.contiguous(), v.contiguous()
