"""Shared layers: a port of ``src/repro/models/layers.py:1-66`` (RMSNorm,
rotary embeddings, the SwiGLU MLP and their initialisers).

Parameters are float32 tensors; compute is bf16 with float32 norms and
activations, as in the reference: weights are cast to the activations'
dtype where the reference casts them (``.astype(dt)``).  Initialisers draw
from an explicit ``torch.Generator`` (the reference's PRNG keys give other
numbers; parity tests carry parameters across with
:func:`repro_torch.models.convert.params_from_reference`).  MoE
(``init_moe``, ``moe``, ``moe_aux_loss``) waits for the MoE configs and
``chunked_softmax_xent`` for training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
