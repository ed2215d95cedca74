"""Shared layers: a port of ``src/repro/models/layers.py`` (RMSNorm,
rotary embeddings, the SwiGLU MLP and their initialisers, ``:1-66``; the
mixture of experts ``init_moe``, ``moe`` and ``moe_aux_loss``, ``:71-131``;
the chunked cross-entropy ``chunked_softmax_xent``, ``:134-174``).

Parameters are float32 tensors; compute is bf16 with float32 norms and
activations, as in the reference: weights are cast to the activations'
dtype where the reference casts them (``.astype(dt)``).  Initialisers draw
from an explicit ``torch.Generator`` (the reference's PRNG keys give other
numbers; parity tests carry parameters across with
:func:`repro_torch.models.convert.params_from_reference`).
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


# ------------------------------------------------------------------ MoE
def init_moe(generator, d_model, d_ff, n_experts, storage_experts=None, device=None):
    """``storage_experts`` >= n_experts pads the expert axis (the stored
    experts, E): pad experts hold zeros and are never routed to (the
    router's width stays n_experts)."""
    E = storage_experts or n_experts

    def padded(shape):
        w = _dense_init(generator, (n_experts,) + shape, device=device)
        if E > n_experts:
            w = torch.cat([w, w.new_zeros((E - n_experts,) + shape)], dim=0)
        return w

    return {
        "router": _dense_init(generator, (d_model, n_experts), device=device),
        "w_gate": padded((d_model, d_ff)),
        "w_up": padded((d_model, d_ff)),
        "w_down": padded((d_ff, d_model)),
    }


def _router_probs(params, x):
    """The router's softmax over the n_experts routable columns, float32."""
    return torch.softmax(x.float() @ params["router"].float(), dim=-1)


def moe(params, x, top_k: int):
    """The reference's dense one-hot dispatch: every token through every
    stored expert, as batched products over the expert axis, and a top-k
    combine weight (zero for the experts not chosen, and for pad experts)
    summing the experts' outputs.  Its work is E / top_k times that of the
    routed experts alone (granite-moe-3b-a800m: 48 stored experts, top 8),
    but it has no host sync and no data-dependent shape.

    The top k are taken by a stable descending sort: among equal weights
    the lower index first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order).  Gradients reach the chosen weights through the
    softmax, not the indices, as under ``jax.grad``."""
    dt, lead = x.dtype, x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1])  # (T, d)
    weights = _router_probs(params, xt)
    top_w, top_i = torch.sort(weights, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :top_k], top_i[:, :top_k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    n_storage = params["w_gate"].shape[0]  # >= the router's width when padded
    combine = top_w.new_zeros((xt.shape[0], n_storage)).scatter(-1, top_i, top_w)  # (T, E)

    g = torch.matmul(xt, params["w_gate"].to(dt))  # (E, T, f)
    u = torch.matmul(xt, params["w_up"].to(dt))
    h = F.silu(g.float()).to(dt) * u
    y = torch.bmm(h, params["w_down"].to(dt))  # (E, T, d)
    # sum over e of y[e, t] combine[t, e]: one (d, E) x (E, 1) product a
    # token, y read in place through a transposed view
    out = torch.bmm(y.permute(1, 2, 0), combine.to(dt)[:, :, None])[:, :, 0]
    return out.reshape(*lead, out.shape[-1])


def moe_aux_loss(params, x):
    """Load-balancing auxiliary loss (Switch-style): n_experts x the sum
    over experts of the mean router probability times the share of tokens
    whose largest probability it holds (``argmax``: the first among
    equals, as in the reference)."""
    probs = _router_probs(params, x)
    n = probs.shape[-1]
    frac = probs.reshape(-1, n).mean(dim=0)
    load = F.one_hot(probs.argmax(dim=-1).reshape(-1), n).float().mean(dim=0)
    return n * torch.sum(frac * load)


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
