"""Plain torch versions of the SSD scan: a port of
``src/repro/kernels/ssd_scan/ref.py`` (the per-step recurrence
``ssd_scan_ref`` and the chunked form ``ssd_scan_chunked``).

xdt: (BH, L, P); dtA: (BH, L); B, C: (BG, L, N); BH == BG * n_rep, head bh
reading group ``bh // n_rep`` (``jnp.repeat`` is ``repeat_interleave``).
Both compute in float32 and return xdt's dtype.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(xdt, dtA, B, C, n_rep):
    """S_t = exp(dtA_t) S_{t-1} + B_t (x) xdt_t ;  y_t = C_t . S_t."""
    BH, L, P = xdt.shape
    N = B.shape[2]
    Bx = B.repeat_interleave(n_rep, dim=0).float()
    Cx = C.repeat_interleave(n_rep, dim=0).float()
    x, a = xdt.float(), dtA.float()
    S = torch.zeros((BH, N, P), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(L):
        S = torch.exp(a[:, t])[:, None, None] * S \
            + Bx[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", Cx[:, t], S))
    return torch.stack(ys, 1).to(xdt.dtype)


def ssd_scan_chunked(xdt, dtA, B, C, n_rep, chunk: int = 128):
    """Within-chunk quadratic form plus the cross-chunk state carry, the
    same math as the kernel."""
    BH, L, P = xdt.shape
    N = B.shape[2]
    chunk = min(chunk, L)
    pad = (-L) % chunk
    x, a = xdt.float(), dtA.float()
    Bx = B.repeat_interleave(n_rep, dim=0).float()
    Cx = C.repeat_interleave(n_rep, dim=0).float()
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, pad))
        Bx = torch.nn.functional.pad(Bx, (0, 0, 0, pad))
        Cx = torch.nn.functional.pad(Cx, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xdt.device))
    S = torch.zeros((BH, N, P), dtype=torch.float32, device=xdt.device)
    ys = []
    for c0 in range(0, L + pad, chunk):
        xc, ac = x[:, c0:c0 + chunk], a[:, c0:c0 + chunk]
        bc, cc = Bx[:, c0:c0 + chunk], Cx[:, c0:c0 + chunk]
        cum = torch.cumsum(ac, dim=1)
        decay = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None, :]), 0.0)
        scores = torch.einsum("bqn,bkn->bqk", cc, bc) * decay
        y = torch.einsum("bqk,bkp->bqp", scores, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum("bqn,bnp->bqp", cc, S)
        d_end = torch.exp(cum[:, -1:] - cum)
        S = torch.exp(cum[:, -1])[:, None, None] * S \
            + torch.einsum("bqn,bqp->bnp", bc, xc * d_end[..., None])
        ys.append(y)
    return torch.cat(ys, 1)[:, :L].to(xdt.dtype)
