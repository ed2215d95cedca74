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
of 64 keys, chunks of the kernel's own length)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
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
