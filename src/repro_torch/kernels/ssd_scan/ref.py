"""Plain torch versions of the SSD scan: a port of
``src/repro/kernels/ssd_scan/ref.py`` (the per-step recurrence
``ssd_scan_ref`` and the chunked form ``ssd_scan_chunked``), and
``ssd_scan_state_passing``, the four steps the CUDA kernels take, and
``ssd_scan_bwd_ref``, the gradients the backward kernels compute, in the
same steps.

xdt: (BH, L, P); dtA: (BH, L); B, C: (BG, L, N); BH == BG * n_rep, head bh
reading group ``bh // n_rep`` (``jnp.repeat`` is ``repeat_interleave``).
The forward forms compute in float32 and return xdt's dtype; the
backward computes in float64 when given float64 inputs, else float32.
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
    same math as the kernel; autograd differentiates it (finite where the
    reference's gradient is NaN, ROADMAP C10)."""
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
        # masked before the exp: the same values as the reference's
        # where(tri, exp(.), 0), but above the diagonal exp(cum_i - cum_j)
        # can overflow, and its gradient there is then 0 * inf = NaN
        # (ROADMAP C10)
        decay = torch.exp(torch.where(tri, cum[:, :, None] - cum[:, None, :], -torch.inf))
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


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds it."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of ``t``: hi = t rounded to TF32, lo = t - hi
    rounded again, in ``t``'s dtype."""
    hi = tf32_round(t.float()).to(t.dtype)
    return hi, tf32_round((t - hi).float()).to(t.dtype)


def einsum_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product ``einsum(eq, a, b)`` as the tensor cores take it in
    3xTF32: each operand split into a TF32 hi and lo part, and hi.hi + hi.lo
    + lo.hi summed (lo.lo dropped)."""
    a_hi, a_lo = _split_tf32(a)
    b_hi, b_lo = _split_tf32(b)
    return torch.einsum(eq, a_hi, b_hi) + (torch.einsum(eq, a_hi, b_lo)
                                           + torch.einsum(eq, a_lo, b_hi))


def ssd_scan_bwd_ref(xdt, dtA, B, C, n_rep, dy, chunk: int = 64, *,
                     ddtA_from_y: bool = False, tf32x3: bool = False,
                     slice_heads: int | None = None):
    """The gradients of y = ssd_scan(xdt, dtA, B, C) against dy, written out
    (not autograd of a forward) in the steps the backward kernels take at
    their chunk Q: (dxdt (BH, L, P), ddtA (BH, L), dB (BG, L, N), dC (BG,
    L, N)), dB and dC summed over each group's heads.

    With cum the inclusive cumsum of dtA within a chunk, S_in the state
    entering it, tri the lower triangle and Lij = exp(cum_i - cum_j) on it:
      b1. dS_in[c] = sum_i exp(cum_i) C_i (x) dy_i, for c >= 1;
      b2. g_c, the gradient of chunk c's end state from later chunks:
          g_{last} = 0, g_c = dS_in[c+1] + exp(cum_end[c+1]) g_{c+1}; and
          dd_c = <g_c, S_in[c]>;
      b3. dxdt_j = sum_{i>=j} (C_i . B_j) Lij dy_i + exp(cum_end - cum_j) B_j g_c;
      b4. with D_ij = (dy_i . xdt_j) Lij:
          dC_i = sum_j D_ij B_j + exp(cum_i) S_in dy_i,
          dB_j = sum_i D_ij C_i + exp(cum_end - cum_j) g_c xdt_j,
          d cum_k = sum_j W_kj - sum_i W_ik + u_k - v_k, W = D o (C B^T),
          u_k = C_k . (exp(cum_k) S_in dy_k), v_k = B_k . (exp(cum_end -
          cum_k) g_c xdt_k), and at the chunk's last row also
          exp(cum_end) dd_c + sum_j v_j; ddtA is the reverse cumsum of
          d cum within the chunk.  W's diagonal and v at the last row add
          to d cum and take from it again: both are left out, which keeps
          ddtA's float32 error down where they dwarf the rest (a strong
          decay).

    Three options, each off by default (today's numbers), give the
    arithmetic of the backward kernels on the card:
      ``ddtA_from_y``: ddtA from the row terms dy_t . y_t - xdt_t . dxdt_t
          (<G_t, S_t> is both ddtA_t + xdt_t . dxdt_t and dy_t . y_t +
          ddtA_{t+1}), with y from this function's own forward steps:
          within each chunk their reverse cumsum, plus ddtA at the next
          chunk's first row, <g_c, S_in[c + 1]>; the row terms in the
          working dtype, their sums in float64; ddtA_0 = exp(dtA_0) <G_0,
          S_-1> is 0 (a zero initial state); no W, u, v;
      ``tf32x3``: each product the kernels run on the tensor cores (b3's
          two, D, the state terms of dC and dB, D's products with B and C)
          takes its operands split as 3xTF32 (:func:`einsum_3xtf32`), the
          row scales exp(cum_i) and exp(cum_end - cum_j) applied to the
          operand first; b1 stays in full precision;
      ``slice_heads``: dB and dC regrouped as the kernel sums them: a
          group's heads cut into slices of that many (the last may be
          short), D summed over a slice before its products with B and C,
          the slices' sums added in order."""
    f = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    mm = einsum_3xtf32 if tf32x3 else torch.einsum
    BH, L, P = xdt.shape
    BG, _, N = B.shape
    R, Q = n_rep, chunk
    nc = -(-L // Q)
    pad = nc * Q - L
    pad_rows = (lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))) if pad else (lambda t: t)
    x = pad_rows(xdt.to(f)).reshape(BG, R, nc, Q, P)
    g_y = pad_rows(dy.to(f)).reshape(BG, R, nc, Q, P)
    a = torch.nn.functional.pad(dtA.to(f), (0, pad)).reshape(BG, R, nc, Q)
    Bc = pad_rows(B.to(f)).reshape(BG, nc, Q, N)
    Cc = pad_rows(C.to(f)).reshape(BG, nc, Q, N)
    cum = torch.cumsum(a, dim=-1)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))
    Lij = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :], -torch.inf))
    ecum = torch.exp(cum)
    wend = torch.exp(cum[..., -1:] - cum)
    decay = torch.exp(cum[..., -1])
    # the forward's states entering each chunk
    s_local = torch.einsum("gcjn,grcjp->grcnp", Bc, x * wend[..., None])
    s_in = torch.zeros_like(s_local)
    for c in range(1, nc):
        s_in[:, :, c] = decay[:, :, c - 1, None, None] * s_in[:, :, c - 1] \
            + s_local[:, :, c - 1]
    # b1, b2
    ds_in = torch.einsum("gcin,grci,grcip->grcnp", Cc, ecum, g_y)
    g = torch.zeros_like(s_local)
    for c in range(nc - 2, -1, -1):
        g[:, :, c] = ds_in[:, :, c + 1] + decay[:, :, c + 1, None, None] * g[:, :, c + 1]
    # b3
    cb = torch.einsum("gcin,gcjn->gcij", Cc, Bc)
    if tf32x3:
        dx = mm("grcij,grcip->grcjp", cb[:, None] * Lij, g_y) \
            + mm("grcjn,grcnp->grcjp", Bc[:, None] * wend[..., None], g)
    else:
        dx = torch.einsum("grcij,grcip->grcjp", cb[:, None] * Lij, g_y) \
            + torch.einsum("gcjn,grcj,grcnp->grcjp", Bc, wend, g)
    # b4
    D = mm("grcip,grcjp->grcij", g_y, x) * Lij
    if tf32x3:
        dc_state = mm("grcip,grcnp->grcin", ecum[..., None] * g_y, s_in)
        db_state = mm("grcjp,grcnp->grcjn", wend[..., None] * x, g)
    else:
        dc_state = ecum[..., None] * torch.einsum("grcip,grcnp->grcin", g_y, s_in)
        db_state = wend[..., None] * torch.einsum("grcjp,grcnp->grcjn", x, g)
    if slice_heads is None:
        dC = mm("grcij,gcjn->gcin", D, Bc) + dc_state.sum(1)
        dB = mm("grcij,gcin->gcjn", D, Cc) + db_state.sum(1)
    else:
        dC = dB = 0
        for h0 in range(0, R, slice_heads):
            heads = slice(h0, h0 + slice_heads)
            d_sum = D[:, heads].sum(1)
            dC = dC + (mm("gcij,gcjn->gcin", d_sum, Bc) + dc_state[:, heads].sum(1))
            dB = dB + (mm("gcij,gcin->gcjn", d_sum, Cc) + db_state[:, heads].sum(1))
    if ddtA_from_y:
        y = torch.einsum("grcij,grcjp->grcip", cb[:, None] * Lij, x) \
            + ecum[..., None] * torch.einsum("gcin,grcnp->grcip", Cc, s_in)
        row = ((g_y * y).sum(-1) - (x * dx).sum(-1)).double()
        # ddtA at chunk c + 1's first row: <g_c, S_in[c + 1]>
        carry = torch.zeros_like(row[..., 0])
        carry[..., :-1] = (g[:, :, :-1] * s_in[:, :, 1:]).sum((-2, -1)).double()
        ddtA = (torch.flip(torch.cumsum(torch.flip(row, (-1,)), -1), (-1,))
                + carry[..., None]).to(f)
        ddtA[:, :, 0, 0] = 0.0  # exp(dtA_0) <G_0, S_-1>: the scan starts from a zero state
    else:
        dd = (g * s_in).sum((-2, -1))
        # the diagonal adds to both sums below and cancels: left out, it
        # costs no precision where it dwarfs the rest (a strong decay)
        W = torch.where(torch.eye(Q, dtype=torch.bool, device=xdt.device), 0.0,
                        D * cb[:, None])
        v = (Bc[:, None] * db_state).sum(-1)
        v[..., -1] = 0.0  # v at the last row adds to it and takes from it: left out too
        dcum = W.sum(-1) - W.sum(-2) + (Cc[:, None] * dc_state).sum(-1) - v
        dcum[..., -1] += decay * dd + v.sum(-1)
        ddtA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    return (dx.reshape(BH, nc * Q, P)[:, :L], ddtA.reshape(BH, nc * Q)[:, :L],
            dB.reshape(BG, nc * Q, N)[:, :L], dC.reshape(BG, nc * Q, N)[:, :L])
