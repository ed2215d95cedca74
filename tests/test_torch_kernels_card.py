"""The flash_attention and ssd_scan CUDA kernels against their plain torch
versions on the card.  These need an NVIDIA GPU with ``nvcc`` and skip
elsewhere; on the card they run with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_card.py

Tolerances are the reference's own (``tests/test_kernels.py``):
flash_attention 2e-5 in float32 and 2e-2 in bf16 (absolute and relative,
outputs compared in float32; bf16 runs the tensor-core kernel, float32 the
CUDA-core one; head dims 16, 64, 96, 128 and 256, and 24, 32 and 80
zero-padded to the next of them); ssd_scan a max error
below 3e-4 of max|y| in float32, and
the states its state pass leaves within 1e-5 of the plain version of its
passes.  The kernels sum in another order than the plain versions (tiles
of 64 keys, chunks of the kernel's own length).

flash_attention's backward kernels against ``flash_attention_bwd_ref`` (the
same formulas, dense, in float32): max |kernel - plain| within 2e-5 of
max |plain| in float32 (float32 sums in another order) and 8e-3 in bf16
(both round float32 sums to bf16 at the end: one bf16 ulp is 2^-8 of the
value; bf16 runs on the tensor cores, which round P and dS to bf16
before their products); the forward's log-sum-exp within 1e-4
of the plain one's; two launches give the same bits; the
``autograd.Function`` against torch autograd of the float32 plain version
within 1e-4 of max |grad|.

ssd_scan's backward kernels (through ``ops.SSDScan``) against
``ssd_scan_bwd_ref`` in float64 within 1e-4 of each gradient's max
|value| (3 and 12 heads a group, which slices of 8 heads do not divide,
and N = 256 among the shapes); two launches give the same bits, also at
mamba2-370m's training inputs with |dtA| up to 50; under a checkpoint, the
gradients of the model-layout inputs against torch autograd of the plain
version on the CPU within 1e-4."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_chunked, ssd_scan_ref,
                                              ssd_scan_state_passing)

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device"),
]


@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D", [
    (1, 4, 2, 256, 256, 64),
    (1, 8, 2, 96, 160, 64),    # lengths the 64-row tiles do not divide
    (2, 4, 4, 100, 100, 128),
    (1, 2, 1, 64, 320, 128),
    (4, 32, 8, 300, 300, 64),  # granite-3-2b's heads
    (2, 4, 2, 24, 24, 16),     # the smoke configs' head dim
    (1, 4, 1, 200, 333, 16),
    (1, 4, 4, 200, 333, 96),   # phi3-mini-3.8b's head dim, MHA
    (1, 4, 2, 333, 200, 96),
    (1, 4, 2, 200, 333, 256),  # gemma3-12b's head dim, GQA
    (1, 4, 4, 333, 200, 256),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(rng, B, Hq, Hk, Sq, Sk, D, causal, dtype):
    q, k, v = (torch.as_tensor(rng.normal(size=s), device="cuda").to(dtype)
               for s in ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D)))
    before = fa_ops.LAUNCHES
    a = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert a.dtype == dtype and a.shape == q.shape
    b = flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [16, 100])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_window(rng, window, n_rep, dtype):
    q = torch.as_tensor(rng.normal(size=(1, 4, 200, 64)), device="cuda").to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(1, 4 // n_rep, 200, 64)),
                            device="cuda").to(dtype) for _ in range(2))
    a = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    b = flash_attention_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


@pytest.mark.parametrize("D", [16, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_decode_offset(rng, D, dtype):
    """Sq = 1 at q_offset 511, and a window that leaves one row of a tile
    with no valid key (it writes 0)."""
    q = torch.as_tensor(rng.normal(size=(2, 4, 1, D)), device="cuda").to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(2, 2, 512, D)), device="cuda").to(dtype)
            for _ in range(2))
    a = fa_ops.flash_attention(q, k, v, causal=True, q_offset=511)
    b = flash_attention_ref(q, k, v, causal=True, q_offset=511)
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])
    empty = fa_ops.flash_attention(q, k, v, causal=False, window=4, q_offset=600)
    assert not empty.any()


@pytest.mark.parametrize("D", [96, 256])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_window_1024(rng, D, n_rep, dtype):
    """gemma3-12b's 1,024-key causal window over 1,300 keys, at the head
    dims phi3-mini-3.8b and gemma3-12b take, with MHA and GQA."""
    q = torch.as_tensor(rng.normal(size=(1, 4, 1300, D)), device="cuda").to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(1, 4 // n_rep, 1300, D)),
                            device="cuda").to(dtype) for _ in range(2))
    a = fa_ops.flash_attention(q, k, v, causal=True, window=1024)
    b = flash_attention_ref(q, k, v, causal=True, window=1024)
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


@pytest.mark.parametrize("D", [288, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_other_head_dims_raise(D, dtype):
    """A head dim above every compiled instance raises on a CUDA tensor,
    naming the instances; nothing falls back to the plain version."""
    q = torch.zeros((1, 2, 8, D), device="cuda", dtype=dtype)
    before = fa_ops.LAUNCHES
    with pytest.raises(ValueError, match="head dim .*256"):
        fa_ops.flash_attention(q, q, q)
    assert fa_ops.LAUNCHES == before


@pytest.mark.parametrize("D", [24, 32, 80])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_pads_between_instances(D, window, dtype):
    """A head dim between the compiled instances runs the next instance on
    zero-padded q, k and v and equals the plain version at D."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32).to("cuda", dtype)
               for s in ((1, 4, 200, D), (1, 2, 333, D), (1, 2, 333, D)))
    before = fa_ops.LAUNCHES
    a = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    assert fa_ops.LAUNCHES == before + 1 and a.shape == q.shape
    b = flash_attention_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


def _ssd_inputs(rng, BH, BG, L, P, N):
    xdt = torch.as_tensor(rng.normal(size=(BH, L, P)) * 0.5, dtype=torch.float32,
                          device="cuda")
    dtA = -torch.as_tensor(rng.uniform(0.01, 0.5, size=(BH, L)), dtype=torch.float32,
                           device="cuda")
    B, C = (torch.as_tensor(rng.normal(size=(BG, L, N)) * 0.3, dtype=torch.float32,
                            device="cuda") for _ in range(2))
    return xdt, dtA, B, C


@pytest.mark.parametrize("BH,BG,L,P,N", [
    (4, 4, 1, 64, 128),
    (4, 2, 100, 32, 64),
    (32, 1, 2048, 64, 128),   # mamba2-370m: 32 heads on one group
    (8, 8, 300, 16, 16),
    (8, 2, 40, 64, 128),      # under one chunk
    (16, 8, 1819, 128, 128),  # jamba-1.5's widths, 8 groups
    (4, 2, 100, 16, 16),      # jamba-1.5's smoke widths, 2 groups
    (70_000, 70_000, 80, 4, 4),  # more heads than a grid's y axis holds
])
def test_ssd_kernel_matches_plain(rng, BH, BG, L, P, N):
    n_rep = BH // BG
    xdt, dtA, B, C = _ssd_inputs(rng, BH, BG, L, P, N)
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda

    a = ssd_scan_cuda(xdt, dtA, B, C, n_rep)
    torch.cuda.synchronize()
    b = ssd_scan_ref(xdt, dtA, B, C, n_rep) if L <= 300 \
        else ssd_scan_chunked(xdt, dtA, B, C, n_rep)
    err = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)
    assert err < 3e-4, err


@pytest.mark.parametrize("BH,BG,L,P,N", [
    (4, 2, 130, 16, 16),
    (32, 1, 1819, 64, 128),   # mamba2-370m's first serving batch, one row
    (16, 8, 300, 128, 128),   # jamba-1.5's widths
])
def test_ssd_kernel_matches_state_passing(rng, BH, BG, L, P, N):
    """Against the plain version of the kernels' own passes at their chunk:
    y, and the states the state pass leaves in the scratch (the state
    entering each chunk past the first)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import chunk, plan

    xdt, dtA, B, C = _ssd_inputs(rng, BH, BG, L, P, N)
    call = plan(xdt, dtA, B, C, BH // BG)
    for _, launch in call.passes:
        launch()
    torch.cuda.synchronize()
    y, s_in = ssd_scan_state_passing(xdt, dtA, B, C, BH // BG, chunk(), return_states=True)
    err = float((call.y - y).abs().max()) / (float(y.abs().max()) + 1e-9)
    assert err < 3e-4, err
    assert call.states.shape == s_in[:, 1:].shape
    assert float((call.states - s_in[:, 1:]).abs().max()) < 1e-5


def test_ssd_ops_launches_once(rng):
    x = torch.as_tensor(rng.normal(size=(2, 70, 4, 16)), dtype=torch.float32, device="cuda")
    dt = torch.as_tensor(rng.uniform(0.05, 0.3, size=(2, 70, 4)), dtype=torch.float32,
                         device="cuda")
    A = -torch.as_tensor(rng.uniform(0.1, 1.0, size=(4,)), dtype=torch.float32, device="cuda")
    Bm, Cm = (torch.as_tensor(rng.normal(size=(2, 70, 2, 16)) * 0.3, dtype=torch.float32,
                              device="cuda") for _ in range(2))
    before = ssd_ops.LAUNCHES
    y = ssd_ops.ssd_scan(x, dt, A, Bm, Cm)
    assert ssd_ops.LAUNCHES == before + 1
    y_cpu = ssd_ops.ssd_scan(*(t.cpu() for t in (x, dt, A, Bm, Cm)))
    err = float((y.cpu() - y_cpu).abs().max()) / float(y_cpu.abs().max())
    assert err < 3e-4, err


BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / (float(b.float().abs().max()) + 1e-9)


def _bwd_case(rng, B, Hq, Hk, Sq, Sk, D, dtype, **kw):
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    q, k, v, do = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32).to("cuda", dtype)
                   for s in ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D), (B, Hq, Sq, D)))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    finite = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), finite)
    if finite.any():
        assert float((lse[finite] - lse_ref[finite]).abs().max()) < 1e-4
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) < BWD_TOL[dtype], (name, _rel(a, b))
    return got


@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,kw", [
    (1, 4, 2, 100, 100, 16, dict(causal=True)),
    (2, 8, 2, 300, 300, 64, dict(causal=True)),    # granite-3-2b's group of 4
    (1, 4, 4, 130, 200, 96, dict(causal=False)),   # phi3-mini-3.8b's head dim, MHA
    (1, 2, 1, 200, 200, 128, dict(causal=True, window=50)),
    (1, 4, 4, 1100, 1100, 256, dict(causal=True, window=1024)),  # gemma3's local layers
    (1, 4, 2, 1, 40, 64, dict(causal=True, q_offset=39)),         # decode offset
    (1, 2, 2, 40, 1000, 256, dict(causal=True, q_offset=960)),
    # ragged Sq and Sk, windows with a query offset, n_rep 1 and 4
    (1, 4, 1, 37, 200, 16, dict(causal=True, q_offset=163)),
    (1, 4, 4, 300, 300, 16, dict(causal=True, window=100)),
    (2, 8, 2, 130, 700, 64, dict(causal=True, window=256, q_offset=570)),
    (1, 4, 4, 1, 300, 64, dict(causal=True, q_offset=299)),
    (1, 8, 2, 333, 200, 96, dict(causal=False)),
    (1, 4, 4, 200, 333, 96, dict(causal=True, window=64, q_offset=133)),
    (1, 4, 1, 500, 500, 128, dict(causal=True)),
    (1, 2, 2, 40, 1000, 128, dict(causal=True, window=300, q_offset=960)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_plain(rng, B, Hq, Hk, Sq, Sk, D, kw, dtype):
    _bwd_case(rng, B, Hq, Hk, Sq, Sk, D, dtype, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_fully_masked_rows_are_zero(rng, dtype):
    """Every key too old for every row (lse = -inf): zero gradients."""
    dq, dk, dv = _bwd_case(rng, 1, 2, 1, 8, 16, 64, dtype, causal=False, window=4,
                           q_offset=40)
    assert not dq.any() and not dk.any() and not dv.any()


@pytest.mark.parametrize("Hq,Hk,S,D,kw", [
    (32, 8, 700, 64, dict(causal=True)),
    (4, 4, 300, 16, dict(causal=True, window=100)),
    (8, 2, 333, 96, dict(causal=False)),
    (4, 1, 500, 128, dict(causal=True, window=300, q_offset=40)),
    (4, 2, 300, 256, dict(causal=True, window=100)),
])
def test_flash_backward_is_deterministic(rng, Hq, Hk, S, D, kw):
    """dQ, dK and dV have one owner each: two launches give the same bits
    (bf16, the tensor-core kernels)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    q, do = (torch.as_tensor(rng.normal(size=(2, Hq, S, D)), dtype=torch.float32)
             .to("cuda", torch.bfloat16) for _ in range(2))
    k, v = (torch.as_tensor(rng.normal(size=(2, Hk, S, D)), dtype=torch.float32)
            .to("cuda", torch.bfloat16) for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    second = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("D", [64, 24])
def test_flash_autograd_function_under_checkpoint(rng, D):
    """ops.flash_attention on CUDA tensors that require grad, inside a
    non-reentrant torch.utils.checkpoint: the forward launches twice, the
    backward once, and the gradients equal torch autograd of the float32
    plain version (D = 24 through the zero padding to 64)."""
    from torch.utils.checkpoint import checkpoint

    arrs = [rng.normal(size=s) for s in ((2, 4, 150, D), (2, 2, 150, D), (2, 2, 150, D))]
    q, k, v = (torch.as_tensor(a, dtype=torch.float32, device="cuda").requires_grad_()
               for a in arrs)
    weight = torch.as_tensor(rng.normal(size=(2, 4, 150, D)), dtype=torch.float32,
                             device="cuda")

    def loss(attend, q, k, v):
        return (attend(q, k, v, causal=True, window=100) * weight).sum()

    fwd, bwd = fa_ops.LAUNCHES, fa_ops.BACKWARD_LAUNCHES
    checkpoint(loss, fa_ops.flash_attention, q, k, v, use_reentrant=False).backward()
    assert fa_ops.LAUNCHES == fwd + 2 and fa_ops.BACKWARD_LAUNCHES == bwd + 1
    got = [t.grad.clone() for t in (q, k, v)]
    want = torch.autograd.grad(loss(flash_attention_ref, q, k, v), (q, k, v))
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-4, _rel(a, b)


def _ssd_kernel_layout(rng, BH, BG, L, P, N, amax=0.5):
    """xdt, dtA (each step in [-amax, -0.01]), B, C and dy on the card,
    float32."""
    arrs = (rng.normal(size=(BH, L, P)) * 0.5, -rng.uniform(0.01, amax, size=(BH, L)),
            rng.normal(size=(BG, L, N)) * 0.3, rng.normal(size=(BG, L, N)) * 0.3,
            rng.normal(size=(BH, L, P)))
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in arrs]


@pytest.mark.parametrize("BH,BG,L,P,N", [
    (4, 4, 1, 64, 128),     # L = 1
    (8, 2, 40, 64, 128),    # under one chunk
    (32, 1, 100, 64, 128),  # ragged, 32 heads on one group
    (8, 8, 150, 16, 16),    # one head a group
    (4, 2, 300, 128, 128),  # jamba-1.5's widths
    (12, 4, 300, 64, 128),  # 3 heads a group: one short slice
    (24, 2, 300, 64, 128),  # 12 heads a group: a full slice and a short one
    (8, 2, 200, 64, 256),   # N = 256, four N tiles
])
def test_ssd_scan_function_gradients_equal_the_plain_backward(rng, BH, BG, L, P, N):
    """``ops.SSDScan`` on CUDA tensors that require grad: its gradients
    (dxdt, ddtA, dB, dC) equal ``ssd_scan_bwd_ref`` in float64 within 1e-4
    of each one's max |value| (float32 sums in another order)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref

    xdt, dtA, B, C, dy = _ssd_kernel_layout(rng, BH, BG, L, P, N)
    ins = [t.clone().requires_grad_() for t in (xdt, dtA, B, C)]
    bwd = ssd_ops.BACKWARD_LAUNCHES
    y = ssd_ops.SSDScan.apply(*ins, BH // BG)
    got = torch.autograd.grad(y, ins, dy)
    assert ssd_ops.BACKWARD_LAUNCHES == bwd + 1
    want = ssd_scan_bwd_ref(*(t.double() for t in (xdt, dtA, B, C)), BH // BG, dy.double())
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a.double(), b) < 1e-4, _rel(a.double(), b)


@pytest.mark.parametrize("L,amax", [(1000, 0.5), (4096, 50.0)])
def test_ssd_backward_is_deterministic(rng, L, amax):
    """Every gradient has one owner and a fixed order: two backward
    launches give the same bits (mamba2-370m's widths, 32 heads on one
    group: ragged, and its training inputs' 4,096 rows at strong decay)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import plan, ssd_scan_bwd_cuda

    xdt, dtA, B, C, dy = _ssd_kernel_layout(rng, 64, 2, L, 64, 128, amax)
    fw = plan(xdt, dtA, B, C, 32)
    for _, launch in fw.passes:
        launch()
    first = ssd_scan_bwd_cuda(xdt, dtA, B, C, 32, fw.states, fw.decay, fw.cbt, fw.y, dy)
    second = ssd_scan_bwd_cuda(xdt, dtA, B, C, 32, fw.states, fw.decay, fw.cbt, fw.y, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_ssd_autograd_function_under_checkpoint(rng):
    """ops.ssd_scan on CUDA tensors that require grad, in the model layout,
    inside a non-reentrant torch.utils.checkpoint: the forward launches
    twice, the backward once, and the gradients of x, dt, A, B and C equal
    torch autograd of the plain version on the CPU within 1e-4."""
    from torch.utils.checkpoint import checkpoint

    arrs = (rng.normal(size=(2, 150, 4, 16)), rng.uniform(0.05, 0.3, size=(2, 150, 4)),
            -rng.uniform(0.1, 1.0, size=(4,)), rng.normal(size=(2, 150, 2, 16)) * 0.3,
            rng.normal(size=(2, 150, 2, 16)) * 0.3)
    weight = rng.normal(size=(2, 150, 4, 16))

    def grads(device):
        ins = [torch.as_tensor(a, dtype=torch.float32, device=device).requires_grad_()
               for a in arrs]
        w = torch.as_tensor(weight, dtype=torch.float32, device=device)
        checkpoint(lambda *t: (ssd_ops.ssd_scan(*t) * w).sum(), *ins,
                   use_reentrant=False).backward()
        return [t.grad.cpu() for t in ins]

    fwd, bwd = ssd_ops.LAUNCHES, ssd_ops.BACKWARD_LAUNCHES
    got = grads("cuda")
    assert ssd_ops.LAUNCHES == fwd + 2 and ssd_ops.BACKWARD_LAUNCHES == bwd + 1
    for a, b in zip(got, grads("cpu")):
        assert _rel(a, b) < 1e-4, _rel(a, b)
    # without grad the forward alone launches, as before
    with torch.no_grad():
        ssd_ops.ssd_scan(*(torch.as_tensor(a, dtype=torch.float32, device="cuda")
                           for a in arrs))
    assert ssd_ops.LAUNCHES == fwd + 3 and ssd_ops.BACKWARD_LAUNCHES == bwd + 1


def test_ssd_backward_passes_one_at_a_time(rng):
    """The backward's launches made one at a time (as ``chip_smoke.py``
    times them) give the whole call's bits."""
    from repro_torch.kernels.ssd_scan.ssd_scan import (BACKWARD_PASSES, backward_plan, plan,
                                                       ssd_scan_bwd_cuda)

    xdt, dtA, B, C, dy = _ssd_kernel_layout(rng, 8, 2, 300, 64, 128)
    fw = plan(xdt, dtA, B, C, 4)
    for _, launch in fw.passes:
        launch()
    call = backward_plan(xdt, dtA, B, C, 4, fw.states, fw.decay, fw.cbt, fw.y, dy)
    assert [name for name, _ in call.passes] == list(BACKWARD_PASSES)
    for _, launch in call.passes:
        launch()
    whole = ssd_scan_bwd_cuda(xdt, dtA, B, C, 4, fw.states, fw.decay, fw.cbt, fw.y, dy)
    assert all(torch.equal(a, b) for a, b in zip((call.dxdt, call.ddtA, call.dB, call.dC),
                                                 whole))


def test_flash_backward_passes_one_at_a_time(rng):
    """The backward's launches made one at a time (as ``chip_smoke.py``
    times them) give the whole call's bits."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        BACKWARD_PASSES, backward_plan, flash_attention_bwd_cuda, flash_attention_cuda)

    q, do = (torch.as_tensor(rng.normal(size=(1, 4, 200, 64)), dtype=torch.float32)
             .to("cuda", torch.bfloat16) for _ in range(2))
    k, v = (torch.as_tensor(rng.normal(size=(1, 2, 200, 64)), dtype=torch.float32)
            .to("cuda", torch.bfloat16) for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    call = backward_plan(q, k, v, o, lse, do)
    assert [name for name, _ in call.passes] == [name for name, _ in BACKWARD_PASSES]
    for _, launch in call.passes:
        launch()
    whole = flash_attention_bwd_cuda(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip((call.dq, call.dk, call.dv), whole))
