"""The port's plain SSD scan versions against the reference's Pallas kernel
(``ssd_scan_pallas(..., interpret=True)``), its ``ops.ssd_scan`` in the
model layout (B, L, H, P), and ``ssd_decode_step`` stepped over a sequence,
on the same inputs made with numpy from a seed; and the plain version of
the CUDA kernels' four passes (``ssd_scan_state_passing``) against the
Pallas kernel, the per-step recurrence and the recurrence's state at every
chunk boundary.

Tolerances are the reference's (``tests/test_kernels.py``): the max error
below 3e-4 of max|y| in float32 and 3e-2 in bf16; decode steps against the
full scan within 1e-4 absolute; the passed states within 1e-5 absolute.  The CUDA kernel itself runs only on the
card: ``test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jax_ops
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_chunked, ssd_scan_ref,
                                              ssd_scan_state_passing)


def _rel_err(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max()) / (float(np.abs(j).max()) + 1e-9)


def _kernel_inputs(rng, BH, BG, L, P, N):
    return (rng.normal(size=(BH, L, P)) * 0.5, -rng.uniform(0.01, 0.5, size=(BH, L)),
            rng.normal(size=(BG, L, N)) * 0.3, rng.normal(size=(BG, L, N)) * 0.3)


@pytest.mark.parametrize("BH,BG,L,P,N,chunk", [
    (4, 2, 256, 32, 64, 64),
    (2, 2, 100, 16, 32, 32),   # a length the chunk does not divide
    (6, 3, 64, 64, 128, 64),
    (32, 1, 70, 16, 16, 32),   # 32 heads on one group
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(rng, BH, BG, L, P, N, chunk, dtype):
    arrs = _kernel_inputs(rng, BH, BG, L, P, N)
    jdt, tdt, tol = ((jnp.float32, torch.float32, 3e-4) if dtype == "float32"
                     else (jnp.bfloat16, torch.bfloat16, 3e-2))
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.as_tensor(a, dtype=torch.float32).to(tdt) for a in arrs]
    pallas = ssd_scan_pallas(*jx, BH // BG, chunk=chunk, interpret=True)
    ref = ssd_scan_ref(*tx, BH // BG)
    chunked = ssd_scan_chunked(*tx, BH // BG, chunk=chunk)
    assert ref.dtype == chunked.dtype == tdt
    assert _rel_err(ref, pallas) < tol
    assert _rel_err(chunked, pallas) < tol


def _recurrence_states(xdt, dtA, B, C, n_rep, chunk):
    """The per-step recurrence's state entering each chunk: (BH, n_chunks,
    N, P), zero for the first."""
    Bx = B.repeat_interleave(n_rep, dim=0)
    S = torch.zeros((xdt.shape[0], B.shape[2], xdt.shape[2]))
    out = []
    for t in range(xdt.shape[1]):
        if t % chunk == 0:
            out.append(S)
        S = torch.exp(dtA[:, t])[:, None, None] * S + Bx[:, t, :, None] * xdt[:, t, None, :]
    return torch.stack(out, 1)


@pytest.mark.parametrize("BH,BG,L,P,N,chunk", [
    (2, 2, 1, 16, 16, 64),       # L = 1
    (4, 2, 40, 16, 16, 64),      # under one chunk
    (4, 2, 150, 16, 16, 64),     # ragged
    (32, 1, 150, 16, 16, 64),    # 32 heads on one group
    (4, 4, 130, 64, 128, 64),    # mamba2-370m's widths, ragged
    (32, 1, 192, 64, 128, 64),   # mamba2-370m's widths and heads
    (4, 2, 100, 128, 128, 64),   # jamba-1.5's widths, ragged
    (2, 1, 96, 128, 128, 32),    # another chunk, dividing L
])
def test_state_passing_matches_pallas_and_recurrence(rng, BH, BG, L, P, N, chunk):
    arrs = _kernel_inputs(rng, BH, BG, L, P, N)
    tx = [torch.as_tensor(a, dtype=torch.float32) for a in arrs]
    pallas = ssd_scan_pallas(*(jnp.asarray(a, jnp.float32) for a in arrs), BH // BG,
                             chunk=chunk, interpret=True)
    y, s_in = ssd_scan_state_passing(*tx, BH // BG, chunk, return_states=True)
    assert y.dtype == torch.float32 and y.shape == (BH, L, P)
    assert _rel_err(y, pallas) < 3e-4
    assert _rel_err(y, ssd_scan_ref(*tx, BH // BG).numpy()) < 3e-4
    assert s_in.shape == (BH, -(-L // chunk), N, P)
    np.testing.assert_allclose(s_in.numpy(), _recurrence_states(*tx, BH // BG, chunk).numpy(),
                               atol=1e-5, rtol=0)


def _model_inputs(rng, Bb, L, H, P, G, N):
    return (rng.normal(size=(Bb, L, H, P)), rng.uniform(0.05, 0.3, size=(Bb, L, H)),
            -rng.uniform(0.1, 1.0, size=(H,)), rng.normal(size=(Bb, L, G, N)) * 0.3,
            rng.normal(size=(Bb, L, G, N)) * 0.3)


@pytest.mark.parametrize("L", [16, 100])
def test_ops_matches_reference_ops(rng, L):
    """Model layout, the pre-fusion of dt, and the reference's choice of the
    per-step form up to 64 steps and the chunked form above."""
    arrs = _model_inputs(rng, 2, L, 4, 8, 2, 16)
    j = jax_ops.ssd_scan(*(jnp.asarray(a, jnp.float32) for a in arrs), use_kernel=False)
    before = ops.LAUNCHES
    t = ops.ssd_scan(*(torch.as_tensor(a, dtype=torch.float32) for a in arrs))
    assert ops.LAUNCHES == before
    assert t.shape == (2, L, 4, 8)
    assert _rel_err(t, j) < 3e-4


def test_decode_steps_match_the_scan(rng):
    Bb, L, H, P, G, N = 2, 16, 4, 8, 2, 16
    arrs = _model_inputs(rng, Bb, L, H, P, G, N)
    x, dt, A, Bm, Cm = (torch.as_tensor(a, dtype=torch.float32) for a in arrs)
    jx, jdt, jA, jB, jC = (jnp.asarray(a, jnp.float32) for a in arrs)
    y_full = jax_ops.ssd_scan(jx, jdt, jA, jB, jC, use_kernel=False)
    state = torch.zeros((Bb, H, N, P))
    jstate = jnp.zeros((Bb, H, N, P), jnp.float32)
    ys = []
    for t in range(L):
        state, y_t = ops.ssd_decode_step(state, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        jstate, jy_t = jax_ops.ssd_decode_step(jstate, jx[:, t], jdt[:, t], jA, jB[:, t], jC[:, t])
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), atol=1e-5, rtol=1e-5)
        ys.append(y_t)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), np.asarray(y_full), atol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=1e-5, rtol=1e-5)


def test_ops_has_no_fallback_off_the_cpu():
    x = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan(x, x[..., 0], x[0, 0, :, 0], x[:, :, :1], x[:, :, :1])
