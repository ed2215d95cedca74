"""The relagg CUDA kernel against its plain torch version, and the port's
TPC-H path on the card against the same path on the CPU.  These need an
NVIDIA GPU with ``nvcc`` and skip elsewhere; on the card they run with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_relagg_card.py

Counts add exact 1.0s and match exactly; sums add in another order than
the plain version's and match to rtol/atol 1e-4."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.relagg import ops
from repro_torch.kernels.relagg.ref import grouped_aggregate_ref

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device"),
]


@pytest.mark.parametrize("n,groups,n_aggs", [
    (64, 1, 1), (257, 7, 1), (4096, 25, 4), (100_000, 130, 8), (50_000, 150_000, 1),
])
def test_relagg_kernel_matches_plain(rng, n, groups, n_aggs):
    gid = rng.integers(-2, groups + 2, n).astype(np.int32)
    mask = rng.random(n) > 0.3
    vals = rng.normal(size=(n, n_aggs)).astype(np.float32)
    args = [torch.as_tensor(a, device="cuda") for a in (gid, mask, vals)]
    before = ops.LAUNCHES
    s, c = ops.grouped_aggregate(*args, groups)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    s2, c2 = grouped_aggregate_ref(*args, groups)
    np.testing.assert_array_equal(c.cpu().numpy(), c2.cpu().numpy())
    np.testing.assert_allclose(s.cpu().numpy(), s2.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["Q5", "Q12"])
def test_tpch_on_card_matches_cpu(name):
    import repro_torch.core as C
    from repro_torch.data.tpch import generate_tpch
    from repro_torch.data.tpch_udfs import QUERIES, register_udfs

    out = []
    for device in ("cpu", "cuda"):
        s = C.Session(device=device)
        generate_tpch(s, sf=0.001)
        register_udfs(s)
        before = ops.LAUNCHES
        t = s.execute(QUERIES[name][0](), C.ExecutionPolicy(pallas_agg=True)).table
        assert ops.LAUNCHES == before + (device == "cuda")
        out.append(t)
    cpu, card = out
    for col in cpu.names():
        a, b = cpu.columns[col], card.columns[col]
        np.testing.assert_array_equal(a.validity().numpy(), b.validity().cpu().numpy())
        np.testing.assert_allclose(b.data.cpu().numpy(), a.data.numpy(), rtol=1e-4)


# The redesigned kernel's own cases.  Counts exact; sums within 1 float32 ulp
# of the float64 sum rounded once, and within 1e-4 x the group's sum of |v|
# of the plain version (whose float32 atomics drift with the magnitudes
# summed, as chip_smoke.py's kernel phase bounds it); on the shared-memory
# path, bit-identical across launches.


def _float64_sums(gid, mask, vals, groups):
    """(sums, sums of |v|) per group in float64."""
    g = gid.cpu().numpy()
    sel = mask.cpu().numpy() & (g >= 0) & (g < groups)
    v = vals.cpu().numpy().astype(np.float64)[sel]
    return tuple(np.stack([np.bincount(g[sel], weights=f(v[:, j]), minlength=groups)
                           for j in range(v.shape[1])], 1) for f in (lambda x: x, np.abs))


def _ulps(a, b):
    def ordered(x):
        i = np.ascontiguousarray(x, dtype=np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _against_plain(args, groups, s, c):
    s2, c2 = grouped_aggregate_ref(*args, groups)
    np.testing.assert_array_equal(c.cpu().numpy(), c2.cpu().numpy())
    sums, absum = _float64_sums(*args, groups)
    ks = s.cpu().numpy()
    assert (np.abs(ks.astype(np.float64) - s2.cpu().numpy()) <= 1e-4 * absum).all()
    assert _ulps(ks, sums.astype(np.float32)).max() <= 1


@pytest.mark.parametrize("n,groups,n_aggs,density", [
    (6_000_000, 7, 4, 0.01), (6_000_000, 25, 2, 0.0012), (1_000_000, 130, 8, 0.6),
    (4096, 1, 1, 0.6),
])
def test_relagg_kernel_repeat_is_bit_identical(rng, n, groups, n_aggs, density):
    from repro_torch.kernels.relagg.relagg import relagg_cuda, uses_shared

    assert uses_shared(groups, n_aggs)
    gid = rng.integers(-1, groups + 1, n).astype(np.int32)
    mask = rng.random(n) < density
    vals = rng.normal(size=(n, n_aggs)).astype(np.float32)
    args = [torch.as_tensor(a, device="cuda") for a in (gid, mask, vals)]
    runs = [relagg_cuda(*args, groups) for _ in range(3)]
    torch.cuda.synchronize()
    s0, c0 = (t.cpu().numpy() for t in runs[0])
    for s, c in runs[1:]:
        assert np.array_equal(s.cpu().numpy().view(np.uint32), s0.view(np.uint32))
        assert np.array_equal(c.cpu().numpy(), c0)
    _against_plain(args, groups, *runs[0])


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize("groups", [7, 150_000])
def test_relagg_kernel_storage_offset(rng, offset, groups):
    """mask and gid as views that start ``offset`` elements into their
    storage: the mask's first byte off a 16-byte boundary."""
    n = 100_000
    gid = torch.as_tensor(rng.integers(0, groups, n + offset).astype(np.int32), device="cuda")
    mask = torch.as_tensor(rng.random(n + offset) > 0.5, device="cuda")
    vals = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device="cuda")
    args = (gid[offset:], mask[offset:], vals)
    assert args[1].storage_offset() == offset and args[1].is_contiguous()
    s, c = ops.grouped_aggregate(*args, groups)
    torch.cuda.synchronize()
    _against_plain(args, groups, s, c)


@pytest.mark.parametrize("n", [1, 15, 17, 1000, 8193, 100_003, 6_000_007])
def test_relagg_kernel_n_not_a_multiple_of_16(rng, n):
    gid = rng.integers(0, 25, n).astype(np.int32)
    mask = rng.random(n) > 0.5
    vals = rng.normal(size=(n, 2)).astype(np.float32)
    args = [torch.as_tensor(a, device="cuda") for a in (gid, mask, vals)]
    s, c = ops.grouped_aggregate(*args, 25)
    torch.cuda.synchronize()
    _against_plain(args, 25, s, c)


@pytest.mark.parametrize("n_aggs", [1, 4])
@pytest.mark.parametrize("side", [0, 1])
def test_relagg_kernel_both_sides_of_the_shared_split(rng, n_aggs, side):
    """The largest G whose warps' slots fit the device's shared memory
    (shared path) and the next one (global path)."""
    from repro_torch.kernels.relagg.relagg import uses_shared

    top = 1
    while uses_shared(top * 2, n_aggs):
        top *= 2
    step = top
    while step > 1:
        step //= 2
        if uses_shared(top + step, n_aggs):
            top += step
    groups = top + side
    assert uses_shared(groups, n_aggs) == (side == 0)
    n = 200_000
    gid = rng.integers(-1, groups + 1, n).astype(np.int32)
    mask = rng.random(n) > 0.3
    vals = rng.normal(size=(n, n_aggs)).astype(np.float32)
    args = [torch.as_tensor(a, device="cuda") for a in (gid, mask, vals)]
    s, c = ops.grouped_aggregate(*args, groups)
    torch.cuda.synchronize()
    _against_plain(args, groups, s, c)
