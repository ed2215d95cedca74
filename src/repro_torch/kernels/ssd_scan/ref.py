"""Plain torch versions of the SSD scan: a port of
``src/repro/kernels/ssd_scan/ref.py`` (the per-step recurrence
``ssd_scan_ref`` and the chunked form ``ssd_scan_chunked``), and
``ssd_scan_state_passing``, the four steps the CUDA kernels take.

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


def ssd_scan_state_passing(xdt, dtA, B, C, n_rep, chunk: int = 64,
                           return_states: bool = False):
    """Mamba-2's chunk-parallel SSD algorithm in the steps the CUDA kernels
    take, vectorised over chunks: (1) C B^T once per group and chunk, (2)
    each chunk's own end state, (3) the states passed from chunk to chunk,
    the only loop, (4) the outputs from the scores and the state entering
    each chunk.  With ``return_states`` it also returns that state,
    S_in (BH, n_chunks, N, P) float32, zero for the first chunk."""
    BH, L, P = xdt.shape
    BG, _, N = B.shape
    Q = chunk
    nc = -(-L // Q)
    pad = nc * Q - L
    pad_rows = (lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))) if pad else (lambda t: t)
    x = pad_rows(xdt.float()).reshape(BG, n_rep, nc, Q, P)
    a = torch.nn.functional.pad(dtA.float(), (0, pad)).reshape(BG, n_rep, nc, Q)
    Bc = pad_rows(B.float()).reshape(BG, nc, Q, N)
    Cc = pad_rows(C.float()).reshape(BG, nc, Q, N)
    cum = torch.cumsum(a, dim=-1)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))
    # 1. C B^T, once per group and chunk
    cb = torch.einsum("gcin,gcjn->gcij", Cc, Bc)
    # 2. each chunk's own end state
    w = torch.exp(cum[..., -1:] - cum)
    s_local = torch.einsum("gcjn,grcjp->grcnp", Bc, x * w[..., None])
    # 3. the states passed from chunk to chunk
    decay = torch.exp(cum[..., -1])
    s_in = torch.zeros_like(s_local)
    for c in range(1, nc):
        s_in[:, :, c] = decay[:, :, c - 1, None, None] * s_in[:, :, c - 1] \
            + s_local[:, :, c - 1]
    # 4. the outputs
    scores = cb[:, None] * torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                                       0.0)
    y = torch.einsum("grcij,grcjp->grcip", scores, x) \
        + torch.exp(cum)[..., None] * torch.einsum("gcin,grcnp->grcip", Cc, s_in)
    y = y.reshape(BH, nc * Q, P)[:, :L].to(xdt.dtype)
    if return_states:
        return y, s_in.reshape(BH, nc, N, P)
    return y
