"""Plain torch versions of flash_attention: a port of
``src/repro/kernels/flash_attention/ref.py`` (``flash_attention_ref`` and
the chunked online-softmax form ``flash_attention_chunked``).

q: (B, Hq, Sq, D); k, v: (B, Hk, Sk, D) with Hq a multiple of Hk.  Query
head h reads KV head ``h // n_rep`` (``jnp.repeat`` along the head axis is
``repeat_interleave``).  A row with no valid key outputs 0, not NaN.
Scores, softmax and the value product are float32; the output has q's
dtype.  ``flash_attention_ref(..., return_lse=True)`` also gives each
row's log-sum-exp, and :func:`flash_attention_bwd_ref` is the backward
kernels' own formulas in plain torch (the reference has no backward
kernel: it differentiates its plain attention).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(Sq: int, Sk: int, causal: bool, window, q_offset: int, device):
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                        sm_scale=None, return_lse=False):
    """o (B, Hq, Sq, D) in q's dtype; with ``return_lse`` (o, lse), lse
    (B, Hq, Sq) float32 the log-sum-exp of each row's scaled scores over
    its valid keys, -inf where it has none."""
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    n_rep = Hq // Hk
    if sm_scale is None:
        sm_scale = D ** -0.5
    k = k.repeat_interleave(n_rep, dim=1)
    v = v.repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, 1.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(denom > 0, m + torch.log(denom), float("-inf"))[..., 0]
    return out, lse.detach()


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=None,
                            q_offset=0, sm_scale=None, round_to_bf16=False):
    """The backward kernels' formulas, dense and in float32: with
    P = exp(S sm_scale - lse) over the valid pairs (0 elsewhere and on a row
    with lse = -inf) and delta = rowsum(dO o O),

        dV = P^T dO,  dS = P o (dO V^T - delta),
        dQ = sm_scale dS K,  dK = sm_scale dS^T Q,

    dK and dV summed over each KV head's group of query heads.  With
    ``round_to_bf16``, P and dS are rounded to bf16 where they enter the
    products that read them (dV, and dK and dQ), as the bf16 tensor-core
    kernels do; dS itself is formed from the unrounded P.  Returns
    (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    n_rep = Hq // Hk
    if sm_scale is None:
        sm_scale = D ** -0.5
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(n_rep, dim=1)
    vf = v.float().repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    lse = lse.float()[..., None]
    valid = _mask(Sq, Sk, causal, window, q_offset, q.device) & torch.isfinite(lse)
    p = torch.where(valid, torch.exp(s - torch.where(valid, lse, 0.0)), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if round_to_bf16:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale

    def grouped(t):  # (B, Hq, Sk, D) -> (B, Hk, Sk, D), each group summed
        return t.reshape(B, Hk, n_rep, Sk, D).sum(dim=2)

    dk = grouped(torch.einsum("bhqk,bhqd->bhkd", ds, qf)) * sm_scale
    dv = grouped(torch.einsum("bhqk,bhqd->bhkd", p, dof))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_chunked(q, k, v, *, causal=True, window=None, q_offset=0,
                            sm_scale=None, bk=512):
    """Online softmax over key blocks of ``bk``: never materializes the
    (Sq, Sk) score matrix (the reference's ``lax.scan`` is a loop here)."""
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    n_rep = Hq // Hk
    if sm_scale is None:
        sm_scale = D ** -0.5
    bk = min(bk, Sk)
    qf = (q.float() * sm_scale).reshape(B, Hk, n_rep, Sq, D)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Hk, n_rep, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hk, n_rep, Sq, D), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, bk):
        kc = k[:, :, start:start + bk].float()
        vc = v[:, :, start:start + bk].float()
        kpos = start + torch.arange(kc.shape[2], device=q.device)
        mask = torch.ones((Sq, kc.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.einsum("bhrqd,bhkd->bhrqk", qf, kc)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhrqk,bhkd->bhrqd", p, vc)
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)
