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

The backward: ``ssd_scan_bwd_ref`` (the gradients the backward kernels
compute, written out at their chunk) against ``jax.grad`` of the
reference's chunked form and of its recurrence, and against torch autograd
of the port's plain forms, each gradient within 1e-5 of its max |value|
(float32 sums in another order; measured up to ~1e-6), beside a control
(dy one position off) that must read far outside; and ``ops.ssd_scan``'s
gradients in the model layout against ``jax.grad`` of the reference's.
Its options, the arithmetic of the backward kernels on the card (ddtA from
y, 3xTF32 products, dB and dC summed over slices of heads), in float32
against ``jax.grad`` of the reference's recurrence and against the float64
plain backward within 1e-4 of each gradient's max |value|, the card's limit
(``chip_smoke.SSD_BWD_TOL``); in float64 the regrouped dB and dC and the
identity's ddtA equal the default form within 1e-12.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels.ssd_scan import ops as jax_ops
from repro.kernels.ssd_scan import ref as jax_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import (einsum_3xtf32, ssd_scan_bwd_ref,
                                              ssd_scan_chunked, ssd_scan_ref,
                                              ssd_scan_state_passing, tf32_round)


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


def test_ops_has_no_fallback_off_the_cpu(monkeypatch):
    """Off the CPU the plain version never runs: a ``meta`` tensor takes
    the card's path to the launch, where the kernels' fake version stands
    in (the dry run's trace), and counts no launch."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ops, "ssd_scan_chunked", plain)
    monkeypatch.setattr(ops, "ssd_scan_ref", plain)
    x = torch.empty((1, 4, 2, 8), device="meta")
    before = ops.LAUNCHES
    y = ops.ssd_scan(x, x[..., 0], x[0, 0, :, 0], x[:, :, :1], x[:, :, :1])
    assert y.device.type == "meta" and y.shape == x.shape
    assert ops.LAUNCHES == before


def test_ops_raise_on_a_device_without_a_kernel():
    """A tensor neither on the CPU, on the card nor on ``meta`` raises
    before anything runs: no plain version, no launch."""
    from types import SimpleNamespace

    x = SimpleNamespace(device=torch.device("xpu"), shape=(1, 4, 2, 8))
    before = ops.LAUNCHES
    with pytest.raises(ValueError, match="no kernel for xpu"):
        ops.ssd_scan(x, x, x, x, x)
    assert ops.LAUNCHES == before


#: the plain backward against jax.grad / autograd, per gradient, of its
#: max |value| (float32 sums in another order)
BWD_TOL = 1e-5

#: (BH, BG, L, P, N): L = 1, under one chunk, ragged with one head a group
#: and with four, 32 heads on one group over three chunks
BWD_SHAPES = [(2, 2, 1, 8, 8), (4, 2, 40, 16, 16), (4, 4, 100, 16, 16),
              (8, 2, 150, 16, 32), (32, 1, 130, 8, 16)]


def _grad_rel(t, j) -> float:
    j = np.asarray(j, np.float64)
    return float(np.abs(t.double().numpy() - j).max()) / (float(np.abs(j).max()) + 1e-12)


@pytest.mark.parametrize("BH,BG,L,P,N", BWD_SHAPES)
@pytest.mark.parametrize("form", ["chunked", "recurrence"])
def test_plain_backward_matches_jax_grad(rng, BH, BG, L, P, N, form):
    """dxdt, ddtA, dB and dC against ``jax.grad`` of the reference's
    ``ssd_scan_chunked`` (at the kernels' chunk of 64) or ``ssd_scan_ref``."""
    arrs = _kernel_inputs(rng, BH, BG, L, P, N)
    dy = rng.normal(size=(BH, L, P))
    n_rep = BH // BG
    fwd = ((lambda *a: jax_ref.ssd_scan_chunked(*a, n_rep, chunk=64)) if form == "chunked"
           else (lambda *a: jax_ref.ssd_scan_ref(*a, n_rep)))
    jdy = jnp.asarray(dy, jnp.float32)
    want = jax.grad(lambda *a: jnp.sum(fwd(*a) * jdy), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a, jnp.float32) for a in arrs))
    tx = [torch.as_tensor(a, dtype=torch.float32) for a in arrs]
    got = ssd_scan_bwd_ref(*tx, n_rep, torch.as_tensor(dy, dtype=torch.float32))
    for name, g, w in zip(("dxdt", "ddtA", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _grad_rel(g, w) < BWD_TOL, (name, _grad_rel(g, w))
    if L > 1:  # control: dy one position off
        off = ssd_scan_bwd_ref(*tx, n_rep, torch.as_tensor(np.roll(dy, 1, axis=1),
                                                           dtype=torch.float32))
        assert min(_grad_rel(g, w) for g, w in zip(off, want)) > 100 * BWD_TOL


@pytest.mark.parametrize("BH,BG,L,P,N", BWD_SHAPES)
@pytest.mark.parametrize("form", ["chunked", "recurrence"])
def test_plain_backward_matches_autograd(rng, BH, BG, L, P, N, form):
    """The same against torch autograd of the port's plain forms (the
    chunked one at its default chunk of 128, another than the kernels')."""
    arrs = _kernel_inputs(rng, BH, BG, L, P, N)
    dy = torch.as_tensor(rng.normal(size=(BH, L, P)), dtype=torch.float32)
    n_rep = BH // BG
    tx = [torch.as_tensor(a, dtype=torch.float32).requires_grad_() for a in arrs]
    fwd = ssd_scan_chunked if form == "chunked" else ssd_scan_ref
    want = torch.autograd.grad(fwd(*tx, n_rep), tx, dy)
    got = ssd_scan_bwd_ref(*(t.detach() for t in tx), n_rep, dy)
    for name, g, w in zip(("dxdt", "ddtA", "dB", "dC"), got, want):
        assert _grad_rel(g, w.numpy()) < BWD_TOL, (name, _grad_rel(g, w.numpy()))


def test_plain_backward_in_float64(rng):
    """Given float64 inputs it computes in float64: against autograd of the
    recurrence written out in float64, within 1e-12."""
    BH, BG, L, P, N = 4, 2, 150, 8, 16
    tx = [torch.as_tensor(a).requires_grad_() for a in _kernel_inputs(rng, BH, BG, L, P, N)]
    dy = torch.as_tensor(rng.normal(size=(BH, L, P)))
    xdt, dtA, B, C = tx
    Bx, Cx = B.repeat_interleave(2, 0), C.repeat_interleave(2, 0)
    S = torch.zeros((BH, N, P), dtype=torch.float64)
    ys = []
    for t in range(L):
        S = torch.exp(dtA[:, t])[:, None, None] * S + Bx[:, t, :, None] * xdt[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", Cx[:, t], S))
    want = torch.autograd.grad(torch.stack(ys, 1), tx, dy)
    got = ssd_scan_bwd_ref(*(t.detach() for t in tx), 2, dy)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and _grad_rel(g, w.numpy()) < 1e-12


def test_ddtA_is_a_reverse_cumsum(rng):
    """The identity behind ``chip_smoke.ssd_bwd_ops_needed``'s count:
    <G_t, S_t> is both ddtA_t + xdt_t . dxdt_t and dy_t . y_t + ddtA_{t+1},
    so ddtA is the reverse cumsum of dy . y - xdt . dxdt, O(P) a row, in
    float64 within 1e-12 of the plain backward's."""
    BH, BG, L, P, N = 4, 2, 150, 8, 16
    xdt, dtA, B, C = (torch.as_tensor(a) for a in _kernel_inputs(rng, BH, BG, L, P, N))
    dy = torch.as_tensor(rng.normal(size=(BH, L, P)))
    dxdt, ddtA, _, _ = ssd_scan_bwd_ref(xdt, dtA, B, C, 2, dy)
    Bx, Cx = B.repeat_interleave(2, 0), C.repeat_interleave(2, 0)
    S = torch.zeros((BH, N, P), dtype=torch.float64)
    ys = []
    for t in range(L):
        S = torch.exp(dtA[:, t])[:, None, None] * S + Bx[:, t, :, None] * xdt[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", Cx[:, t], S))
    y = torch.stack(ys, 1)
    row = (dy * y).sum(-1) - (xdt * dxdt).sum(-1)
    want = row.flip(1).cumsum(1).flip(1)
    assert _grad_rel(ddtA, want.numpy()) < 1e-12


@pytest.mark.parametrize("L", [16, 100])
def test_ops_gradients_match_reference_ops(rng, L):
    """``ops.ssd_scan``'s gradients on the CPU (autograd of the plain form
    the reference picks) with respect to x, dt, A, B and C, through the
    pre-fusion and the layout reshapes, against ``jax.grad`` of the
    reference's ``ops.ssd_scan``."""
    arrs = _model_inputs(rng, 2, L, 4, 8, 2, 16)
    w = rng.normal(size=(2, L, 4, 8))
    jw = jnp.asarray(w, jnp.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_ops.ssd_scan(*a, use_kernel=False) * jw),
                    argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a, jnp.float32) for a in arrs))
    tx = [torch.as_tensor(a, dtype=torch.float32).requires_grad_() for a in arrs]
    (ops.ssd_scan(*tx) * torch.as_tensor(w, dtype=torch.float32)).sum().backward()
    for t, j in zip(tx, want):
        assert _grad_rel(t.grad, j) < 1e-5


def test_chunked_gradient_is_finite_where_the_reference_is_nan(rng):
    """ROADMAP C10: with a decay of ~11 a step (mamba's A = -16 at dt
    ~0.7), exp(cum_i - cum_j) above a chunk's diagonal overflows, and the
    reference's chunked form, which zeroes it with ``where`` after the exp,
    has NaN gradients; the port's masks before the exp (the same forward
    values) and differentiates to the recurrence's gradients, as does the
    plain backward."""
    BH, BG, L, P, N = 4, 2, 150, 8, 16
    xdt, _, B, C = _kernel_inputs(rng, BH, BG, L, P, N)
    dtA = -rng.uniform(8.0, 12.0, size=(BH, L))
    arrs = (xdt, dtA, B, C)
    dy = rng.normal(size=(BH, L, P))
    jx = [jnp.asarray(a, jnp.float32) for a in arrs]
    jdy = jnp.asarray(dy, jnp.float32)

    def grads(fwd):
        return jax.grad(lambda *a: jnp.sum(fwd(*a, 2) * jdy), argnums=(0, 1, 2, 3))(*jx)

    assert any(bool(jnp.isnan(g).any()) for g in grads(jax_ref.ssd_scan_chunked))
    want = grads(jax_ref.ssd_scan_ref)
    tx = [torch.as_tensor(a, dtype=torch.float32).requires_grad_() for a in arrs]
    tdy = torch.as_tensor(dy, dtype=torch.float32)
    y = ssd_scan_chunked(*tx, 2)
    assert _rel_err(y.detach(), jax_ref.ssd_scan_chunked(*jx, 2)) < 3e-4
    got = torch.autograd.grad(y, tx, tdy)
    plain = ssd_scan_bwd_ref(*(t.detach() for t in tx), 2, tdy)
    for name, g, p, w in zip(("dxdt", "ddtA", "dB", "dC"), got, plain, want):
        assert torch.isfinite(g).all() and torch.isfinite(p).all(), name
        # ddtA sums terms that cancel (each pair of rows adds to one row's
        # d cum and takes from the other's), more so at this decay: autograd
        # of the chunked form 2e-3 (measured 3.3e-4 to 9.8e-4 over three
        # seeds against float64), the plain backward, which leaves the
        # cancelling diagonal out, 1e-4 (measured 2.5e-5 to 3.3e-5)
        tol_g, tol_p = (2e-3, 1e-4) if name == "ddtA" else (BWD_TOL, BWD_TOL)
        assert _grad_rel(g, w) < tol_g and _grad_rel(p, w) < tol_p, name


#: the backward kernels' arithmetic on the card (``ssd_scan_bwd_ref``'s
#: options) against jax.grad of the recurrence and the float64 plain
#: backward, per gradient, of its max |value|: the card's own limit
KERNEL_ARITH_TOL = 1e-4
KERNEL_OPTIONS = {
    "identity": {"ddtA_from_y": True},
    "tf32x3": {"tf32x3": True, "slice_heads": 8},
    "both": {"ddtA_from_y": True, "tf32x3": True, "slice_heads": 8},
}
#: (BH, BG, L, P, N, largest |dtA| a step): ragged lengths; 1, 3 and 32
#: heads a group; P and N of 16, and mamba2-370m's 64 and 128
KERNEL_ARITH_SHAPES = [(2, 2, 100, 16, 16, 0.5), (6, 2, 150, 16, 16, 12.0),
                       (32, 1, 130, 16, 16, 0.5), (4, 4, 130, 64, 128, 12.0),
                       (6, 2, 90, 64, 128, 0.5), (32, 1, 100, 64, 128, 12.0)]


@functools.lru_cache(maxsize=None)
def _kernel_arith_case(BH, BG, L, P, N, amax):
    """Inputs (float32 numpy), jax.grad of the reference's recurrence in
    float32, and the float64 plain backward."""
    rng = np.random.default_rng(BH * 1000 + L)
    arrs = (rng.normal(size=(BH, L, P)) * 0.5,
            -(0.01 + (amax - 0.01) * rng.uniform(size=(BH, L))),
            rng.normal(size=(BG, L, N)) * 0.3, rng.normal(size=(BG, L, N)) * 0.3)
    arrs = tuple(a.astype(np.float32) for a in arrs)
    dy = rng.normal(size=(BH, L, P)).astype(np.float32)
    n_rep = BH // BG
    jdy = jnp.asarray(dy)
    recurrence = jax.grad(lambda *a: jnp.sum(jax_ref.ssd_scan_ref(*a, n_rep) * jdy),
                          argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrs))
    f64 = ssd_scan_bwd_ref(*(torch.as_tensor(a, dtype=torch.float64) for a in arrs), n_rep,
                           torch.as_tensor(dy, dtype=torch.float64))
    return arrs, dy, [np.asarray(g) for g in recurrence], [g.numpy() for g in f64]


@pytest.mark.parametrize("option", sorted(KERNEL_OPTIONS))
@pytest.mark.parametrize("BH,BG,L,P,N,amax", KERNEL_ARITH_SHAPES)
def test_kernel_arithmetic_matches_jax_grad_and_float64(BH, BG, L, P, N, amax, option):
    """``ssd_scan_bwd_ref`` with the backward kernels' arithmetic, in
    float32: each gradient within 1e-4 of its max |value| of ``jax.grad``
    of the reference's per-step recurrence and of the float64 plain
    backward."""
    arrs, dy, recurrence, f64 = _kernel_arith_case(BH, BG, L, P, N, amax)
    got = ssd_scan_bwd_ref(*(torch.as_tensor(a) for a in arrs), BH // BG, torch.as_tensor(dy),
                           **KERNEL_OPTIONS[option])
    for name, g, r, w in zip(("dxdt", "ddtA", "dB", "dC"), got, recurrence, f64):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _grad_rel(g, r) < KERNEL_ARITH_TOL, (name, "recurrence", _grad_rel(g, r))
        assert _grad_rel(g, w) < KERNEL_ARITH_TOL, (name, "float64", _grad_rel(g, w))


@pytest.mark.parametrize("slice_heads", [1, 3, 8, 12])
def test_regrouped_dB_dC_equal_the_per_head_form(rng, slice_heads):
    """In float64, dB and dC with D summed over slices of a group's heads
    before its products with B and C (12 heads a group: slices that divide
    it and one, 8, that does not) equal the per-head form within 1e-12, and
    the option leaves dxdt and ddtA as they were."""
    BH, BG, L, P, N = 24, 2, 150, 8, 16
    tx = [torch.as_tensor(a) for a in _kernel_inputs(rng, BH, BG, L, P, N)]
    dy = torch.as_tensor(rng.normal(size=(BH, L, P)))
    want = ssd_scan_bwd_ref(*tx, BH // BG, dy)
    got = ssd_scan_bwd_ref(*tx, BH // BG, dy, slice_heads=slice_heads)
    for name, g, w in zip(("dxdt", "ddtA", "dB", "dC"), got, want):
        assert g.dtype == torch.float64 and _grad_rel(g, w.numpy()) < 1e-12, name


@pytest.mark.parametrize("BH,BG,L,amax", [(4, 2, 150, 0.5), (6, 2, 200, 12.0), (3, 3, 64, 0.5),
                                         (3, 3, 1, 0.5)])
def test_identity_ddtA_equals_the_chunk_form(rng, BH, BG, L, amax):
    """In float64, ddtA as the reverse cumsum over the sequence of dy . y -
    xdt . dxdt (y from the plain backward's own forward steps) equals the
    within-chunk form (W, u, v and dd_c) within 1e-12, exactly 0 at the
    first row (L = 1 among the cases); the other gradients are
    unchanged."""
    P, N = 8, 16
    xdt, _, B, C = _kernel_inputs(rng, BH, BG, L, P, N)
    dtA = -(0.01 + (amax - 0.01) * rng.uniform(size=(BH, L)))
    tx = [torch.as_tensor(a) for a in (xdt, dtA, B, C)]
    dy = torch.as_tensor(rng.normal(size=(BH, L, P)))
    want = ssd_scan_bwd_ref(*tx, BH // BG, dy)
    got = ssd_scan_bwd_ref(*tx, BH // BG, dy, ddtA_from_y=True)
    for name, g, w in zip(("dxdt", "ddtA", "dB", "dC"), got, want):
        assert g.dtype == torch.float64 and _grad_rel(g, w.numpy()) < 1e-12, name


def test_tf32_round_is_cvt_rna():
    """``tf32_round`` keeps 10 mantissa bits, rounding to nearest with ties
    away from zero (``cvt.rna.tf32.f32``); the 3xTF32 split keeps hi + lo
    within 2^-22 of the value, and ``einsum_3xtf32`` a product within
    float32's reach of the float64 one, where one TF32 pass is ~1e-3 off."""
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-12, 2.0**-130],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 2.0**-130],
                        dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    rng = np.random.default_rng(5)
    a, b = (torch.as_tensor(rng.normal(size=(64, 64)), dtype=torch.float32) for _ in range(2))
    exact = a.double() @ b.double()
    three = einsum_3xtf32("ik,kj->ij", a, b)
    one = tf32_round(a) @ tf32_round(b)
    scale = float(exact.abs().max())
    assert float((three.double() - exact).abs().max()) / scale < 1e-6
    assert float((one.double() - exact).abs().max()) / scale > 1e-4
