"""Shared layers: a port of ``src/repro/models/layers.py`` (RMSNorm,
rotary embeddings, the SwiGLU MLP and their initialisers, ``:1-66``; the
chunked cross-entropy ``chunked_softmax_xent``, ``:134-174``).

Parameters are float32 tensors; compute is bf16 with float32 norms and
activations, as in the reference: weights are cast to the activations'
dtype where the reference casts them (``.astype(dt)``).  Initialisers draw
from an explicit ``torch.Generator`` (the reference's PRNG keys give other
numbers; parity tests carry parameters across with
:func:`repro_torch.models.convert.params_from_reference`).  MoE
(``init_moe``, ``moe``, ``moe_aux_loss``) waits for the MoE configs
(ROADMAP A19).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

COMPUTE_DTYPE = torch.bfloat16


def _dense_init(generator: torch.Generator, shape, scale=None, device=None):
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    scale = scale if scale is not None else fan_in ** -0.5
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device or generator.device) * scale


# ------------------------------------------------------------------ norms
def rmsnorm(x, w, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def init_rmsnorm(d, device=None):
    return torch.zeros((d,), dtype=torch.float32, device=device)


# ------------------------------------------------------------------ rope
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, D) with D even; positions: broadcastable to (..., S)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP
def init_mlp(generator, d_model, d_ff, device=None):
    return {
        "w_gate": _dense_init(generator, (d_model, d_ff), device=device),
        "w_up": _dense_init(generator, (d_model, d_ff), device=device),
        "w_down": _dense_init(generator, (d_ff, d_model), device=device),
    }


def mlp(params, x):
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    h = F.silu(g.float()).to(dt) * u
    return h @ params["w_down"].to(dt)


# ------------------------------------------------------------------ losses
def _xent_chunk(xi, wf, li, mi):
    """(sum of the masked NLL, count of masked positions) over one chunk;
    its (B, chunk, V) float32 logits live only inside this call."""
    logits = xi.float() @ wf
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[..., None])[..., 0]
    mf = mi.float()
    return torch.sum((lse - gold) * mf), torch.sum(mf)


def chunked_softmax_xent(x, w_head, labels, mask=None, chunk: int = 512):
    """Next-token CE without materializing (B, S, V) logits: the sequence
    is processed in chunks, each computing float32 logits -> logsumexp ->
    label logit and discarding the logits; each chunk is rematerialised
    (``torch.utils.checkpoint``), so the backward recomputes its logits.
    The reference's padding to a multiple of ``chunk``, masking and
    ``max(count, 1)`` denominator.

    x: (B, S, D); w_head: (D, V); labels: (B, S) integer; mask: (B, S)
    bool or None (every position counts)."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    labels = labels.long()
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = torch.cat([mask, mask.new_zeros((B, pad))], dim=1)
    wf = w_head.float()
    total, count = [], []
    for c in range(0, S + pad, chunk):
        nll, n = checkpoint(_xent_chunk, x[:, c:c + chunk], wf, labels[:, c:c + chunk],
                            mask[:, c:c + chunk], use_reentrant=False)
        total.append(nll)
        count.append(n)
    return torch.stack(total).sum() / torch.clamp(torch.stack(count).sum(), min=1.0)
