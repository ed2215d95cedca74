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
from repro_torch.kernels.relagg.ref import grouped_aggregate_batched_ref, grouped_aggregate_ref

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


# The batched kernel (a GroupAgg inside a correlated subquery): each item
# against an unbatched launch on its own inputs, the same bits on the
# shared-memory path; counts exact everywhere.


def _batched_args(rng, B, n, groups, n_aggs, stride0):
    mask = torch.as_tensor(rng.random((B, n)) > 0.4, device="cuda")
    if stride0:  # one item's gid and vals for every item, as inner columns
        gid = torch.as_tensor(rng.integers(-1, groups + 1, n).astype(np.int32),
                              device="cuda").expand(B, n)
        vals = torch.as_tensor(rng.normal(size=(n, n_aggs)).astype(np.float32),
                               device="cuda").expand(B, n, n_aggs)
    else:
        gid = torch.as_tensor(rng.integers(-1, groups + 1, (B, n)).astype(np.int32),
                              device="cuda")
        vals = torch.as_tensor(rng.normal(size=(B, n, n_aggs)).astype(np.float32),
                               device="cuda")
    return gid, mask, vals


def _against_unbatched(gid, mask, vals, groups, out):
    from repro_torch.kernels.relagg.relagg import relagg_cuda, uses_shared

    k = vals.shape[-1]
    for b, item in enumerate(zip(gid.unbind(0), mask.unbind(0), vals.unbind(0))):
        s, c = relagg_cuda(*item, groups)
        np.testing.assert_array_equal(out[b, :, k].cpu().numpy(), c.cpu().numpy())
        if uses_shared(groups, k):
            assert np.array_equal(out[b, :, :k].cpu().numpy().view(np.uint32),
                                  s.cpu().numpy().view(np.uint32)), b
        else:
            _against_plain(item, groups, out[b, :, :k], out[b, :, k])


@pytest.mark.parametrize("stride0", [False, True], ids=["batched", "stride0"])
@pytest.mark.parametrize("B,n,groups,n_aggs", [
    (1, 4096, 7, 4), (3, 100_000, 25, 2), (16, 6_000_000, 7, 2), (5, 50_000, 150_000, 1),
])
def test_relagg_batched_matches_unbatched_launches(rng, B, n, groups, n_aggs, stride0):
    from repro_torch.kernels.relagg.relagg import relagg_cuda_batched

    args = _batched_args(rng, B, n, groups, n_aggs, stride0)
    out = relagg_cuda_batched(*args, groups)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (B, groups, n_aggs + 1)
    _against_unbatched(*args, groups, out)


def test_relagg_batched_empty_batch():
    from repro_torch.kernels.relagg.relagg import relagg_cuda_batched

    out = relagg_cuda_batched(torch.zeros((0, 9), dtype=torch.int32, device="cuda"),
                              torch.zeros((0, 9), dtype=torch.bool, device="cuda"),
                              torch.zeros((0, 9, 3), device="cuda"), 5)
    assert tuple(out.shape) == (0, 5, 4)


@pytest.mark.parametrize("groups,n_aggs", [(7, 4), (1000, 1)], ids=["shared", "global"])
def test_relagg_batched_past_the_grid_y_limit(rng, groups, n_aggs):
    """70,000 items of 64 rows: more than gridDim.y's 65,535, so two
    launches or more, in order on one stream."""
    from repro_torch.kernels.relagg.relagg import relagg_cuda_batched

    args = _batched_args(rng, 70_000, 64, groups, n_aggs, stride0=False)
    out = relagg_cuda_batched(*args, groups)
    s, c = (t.cpu().numpy() for t in grouped_aggregate_batched_ref(*args, groups))
    np.testing.assert_array_equal(out[..., n_aggs].cpu().numpy(), c)
    np.testing.assert_allclose(out[..., :n_aggs].cpu().numpy(), s, rtol=1e-4, atol=1e-4)
    picks = [0, 65_534, 65_535, 65_536, 69_999]
    _against_unbatched(*(a[picks] for a in args), groups, out[picks])


def test_relagg_batched_global_path_chunks_its_scratch(rng):
    """G = 150,000 at 300 items: each item's float64 accumulator is
    300,000 slots, so the scratch budget splits the batch into chunks."""
    from repro_torch.kernels.relagg.relagg import (
        SCRATCH_BUDGET, relagg_cuda_batched, uses_shared)

    groups, B = 150_000, 300
    assert not uses_shared(groups, 1) and B * groups * 2 > SCRATCH_BUDGET
    args = _batched_args(rng, B, 1000, groups, 1, stride0=True)
    out = relagg_cuda_batched(*args, groups)
    s, c = (t.cpu().numpy() for t in grouped_aggregate_batched_ref(*args, groups))
    np.testing.assert_array_equal(out[..., 1].cpu().numpy(), c)
    np.testing.assert_allclose(out[..., :1].cpu().numpy(), s, rtol=1e-4, atol=1e-4)


def test_relagg_under_vmap_launches_the_batched_kernel(rng, monkeypatch):
    """``grouped_aggregate`` under ``torch.func.vmap`` on CUDA tensors: one
    batched launch, and neither plain version called."""
    def refuse(*a):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(ops, "grouped_aggregate_ref", refuse)
    monkeypatch.setattr(ops, "grouped_aggregate_batched_ref", refuse)
    gid, mask, vals = _batched_args(rng, 6, 20_000, 7, 2, stride0=True)
    before, batched = ops.LAUNCHES, ops.BATCHED_LAUNCHES
    s, c = torch.func.vmap(lambda m: ops.grouped_aggregate(gid[0], m, vals[0], 7))(mask)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.BATCHED_LAUNCHES) == (before + 1, batched + 1)
    _against_unbatched(gid, mask, vals, 7, torch.cat([s, c[..., None]], -1))


def test_relagg_global_path_from_two_threads(rng):
    """Two host threads on one stream, both on the global path (150,000
    groups) at once, 200 calls each: every result equals one thread's
    alone (the stream's launch lock keeps a call's two kernels, which share
    the stream's kept accumulator, together on the stream)."""
    import threading

    from repro_torch.kernels.relagg.relagg import uses_shared

    groups = 150_000
    assert not uses_shared(groups, 2)
    gid = torch.as_tensor(rng.integers(-2, groups + 2, 100_000).astype(np.int32), device="cuda")
    mask = torch.as_tensor(rng.random(100_000) > 0.3, device="cuda")
    vals = torch.as_tensor(rng.normal(size=(100_000, 2)).astype(np.float32), device="cuda")
    s2, c2 = grouped_aggregate_ref(gid, mask, vals, groups)
    barrier = threading.Barrier(2)
    outs: list[list] = [[], []]

    def work(t: int) -> None:
        barrier.wait(timeout=60)
        for _ in range(200):
            outs[t].append(ops.grouped_aggregate(gid, mask, vals, groups))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert [len(o) for o in outs] == [200, 200]
    for s, c in outs[0] + outs[1]:
        assert torch.equal(c, c2)
        torch.testing.assert_close(s, s2, rtol=1e-4, atol=1e-4)
