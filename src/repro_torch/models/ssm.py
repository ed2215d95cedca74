"""Mamba-2 (SSD) mixer block: a port of ``src/repro/models/ssm.py`` —
fused in-projection, short causal depthwise conv, the SSD selective scan
(the Hopper kernel on the card), gated RMSNorm and out-projection, in
sequence form for prefill (``mamba_seq``, with the exact final state for
the prefill-to-decode handoff, ``:91-99``) and single-token form for
serving (``mamba_decode``).

``torch.nn.functional.softplus`` turns linear above its threshold of 20
where ``jax.nn.softplus`` does not; the two differ there by less than
float32 rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_decode_step, ssd_scan
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dense_init, init_rmsnorm, rmsnorm


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return s, d_in, H, conv_dim


def init_mamba(generator, cfg: ArchConfig, device=None):
    s, d_in, H, conv_dim = _dims(cfg)
    device = device or generator.device
    return {
        # fused in-proj: [z (gate), x, B, C, dt]
        "w_in": _dense_init(
            generator, (cfg.d_model, 2 * d_in + 2 * s.n_groups * s.state_dim + H),
            device=device),
        "conv_w": _dense_init(generator, (s.conv_kernel, conv_dim), scale=0.5,
                              device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "gate_norm": init_rmsnorm(d_in, device),
        "w_out": _dense_init(generator, (d_in, cfg.d_model), device=device),
    }


def _split_proj(cfg, proj):
    s, d_in, H, _ = _dims(cfg)
    gN = s.n_groups * s.state_dim
    z, xBC, dt_raw = torch.split(proj, [d_in, d_in + 2 * gN, H], dim=-1)
    return z, xBC, dt_raw


def mamba_seq(params, x_in, cfg: ArchConfig):
    """Sequence form.  Returns (out, (conv_state, ssd_state)): the final
    states for the cache handoff after prefill."""
    s, d_in, H, conv_dim = _dims(cfg)
    B, S, D = x_in.shape
    dt_ = x_in.dtype
    gN = s.n_groups * s.state_dim

    proj = x_in @ params["w_in"].to(dt_)
    z, xBC, dt_raw = _split_proj(cfg, proj)

    # short causal depthwise conv over the sequence
    k = s.conv_kernel
    xBC_pad = F.pad(xBC, (0, 0, k - 1, 0))
    conv_w = params["conv_w"].to(dt_)
    conv = xBC_pad[:, 0:S, :] * conv_w[0]
    for i in range(1, k):
        conv = conv + xBC_pad[:, i:i + S, :] * conv_w[i]
    conv = F.silu(conv.float()).to(dt_)
    xs, Bm, Cm = torch.split(conv, [d_in, gN, gN], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, S, H)
    A = -torch.exp(params["A_log"])  # (H,) negative
    xh = xs.reshape(B, S, H, s.head_dim)
    Bm = Bm.reshape(B, S, s.n_groups, s.state_dim)
    Cm = Cm.reshape(B, S, s.n_groups, s.state_dim)

    y = ssd_scan(xh.float(), dt, A, Bm.float(), Cm.float())
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(dt_)

    y = rmsnorm(y, params["gate_norm"], cfg.norm_eps) * F.silu(z.float()).to(dt_)
    out = y @ params["w_out"].to(dt_)

    conv_state = xBC[:, -(k - 1):, :] if k > 1 else xBC.new_zeros((B, 0, conv_dim))
    # exact final SSD state for the prefill->decode handoff:
    #   S = sum_s exp(cumA_S - cumA_s) . B_s (x) (dt_s x_s)
    dtA = dt * A  # (B, S, H)
    cum = torch.cumsum(dtA, dim=1)
    decay_end = torch.exp(cum[:, -1:, :] - cum)  # (B, S, H)
    n_rep = H // s.n_groups
    B_rep = Bm.float().repeat_interleave(n_rep, dim=2)  # (B, S, H, N)
    xdt = xh.float() * dt[..., None]  # (B, S, H, P)
    ssd_state = torch.einsum("bsh,bshn,bshp->bhnp", decay_end, B_rep, xdt)
    return out, (conv_state, ssd_state)


def mamba_decode(params, x_in, state, cfg: ArchConfig):
    """Single-token decode.  state = (conv_state (B, k-1, conv_dim),
    ssd_state (B, H, N, P))."""
    s, d_in, H, conv_dim = _dims(cfg)
    B, _, D = x_in.shape
    dt_ = x_in.dtype
    gN = s.n_groups * s.state_dim
    conv_state, ssd_state = state

    proj = x_in @ params["w_in"].to(dt_)
    z, xBC, dt_raw = _split_proj(cfg, proj)  # (B, 1, .)

    window = torch.cat([conv_state, xBC], dim=1)  # (B, k, conv_dim)
    conv = torch.einsum("bkc,kc->bc", window.float(), params["conv_w"].float())
    conv = F.silu(conv)[:, None, :].to(dt_)
    new_conv_state = window[:, 1:, :]

    xs, Bm, Cm = torch.split(conv[:, 0], [d_in, gN, gN], dim=-1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"][None, :])  # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B, H, s.head_dim).float()
    Bt = Bm.reshape(B, s.n_groups, s.state_dim).float()
    Ct = Cm.reshape(B, s.n_groups, s.state_dim).float()

    new_ssd, y = ssd_decode_step(ssd_state, xh, dt, A, Bt, Ct)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, 1, d_in).to(dt_)
    y = rmsnorm(y, params["gate_norm"], cfg.norm_eps) * F.silu(z.float()).to(dt_)
    out = y @ params["w_out"].to(dt_)
    return out, (new_conv_state, new_ssd)

