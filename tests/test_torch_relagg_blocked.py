"""The relagg CUDA kernel's scheme in plain torch, and its launch plan, on
the CPU.

``grouped_aggregate_blocked`` sums each block's rows of a fixed partition
in float64, adds the blocks' partials in block order (in groups of 12
blocks, then the groups in order) and rounds once to float32, as
``csrc/relagg.cu`` does on its shared-memory path.  It is held
to the JAX kernel (Pallas in interpret mode, as ``tests/test_kernels.py``
runs it) at the reference's rtol/atol 1e-4 (``tests/test_kernels.py:25``),
to a float64 numpy sum within 1 float32 ulp, and its counts to the same
exact values whatever the number of blocks.

``launch_plan`` is a pure function of the device's SM count and
shared-memory budget, n, G and k: the grid, the rows each block owns, the
path, the shared memory and the scratch it takes, at the main path's
shapes (TPC-H Q12: G = 7, k = 4; Q5: G = 25, k = 2; 6,000,000 rows) and at
the edges."""
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.relagg.relagg import relagg_pallas
from repro_torch.kernels.relagg.ref import (BLOCK_GROUP, grouped_aggregate_blocked,
                                            rows_per_block)
from repro_torch.kernels.relagg.relagg import (GLOBAL_SMEM, LIST, MIN_ROWS_PER_BLOCK,
                                               THREADS, WARPS, launch_plan, shared_bytes)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# H100: SMs, and the dynamic shared memory the shared-memory kernel may opt
# in to (the device's 232,448 bytes a block less the kernel's 16 static ones)
H100_SMS, H100_SMEM = 132, 232_448 - 16


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_relagg", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(rng, n, groups, n_aggs, outside=0.0):
    gid = rng.integers(0, groups, n).astype(np.int32)
    flip = rng.random(n) < outside
    gid[flip] = np.where(rng.random(int(flip.sum())) < 0.5, -1, groups + 2)
    mask = rng.random(n) > 0.4
    vals = rng.normal(size=(n, n_aggs)).astype(np.float32)
    return gid, mask, vals


def _blocked(gid, mask, vals, groups, blocks):
    s, c = grouped_aggregate_blocked(torch.as_tensor(gid), torch.as_tensor(mask),
                                     torch.as_tensor(vals), groups, blocks)
    return s.numpy(), c.numpy()


def _f64(gid, mask, vals, groups):
    sel = mask & (gid >= 0) & (gid < groups)
    g, v = gid[sel], vals[sel].astype(np.float64)
    sums = np.stack([np.bincount(g, weights=v[:, j], minlength=groups)
                     for j in range(vals.shape[1])], 1)
    return sums, np.bincount(g, minlength=groups)


@pytest.mark.parametrize("n", [257, 4096])
@pytest.mark.parametrize("groups", [1, 8, 130])
@pytest.mark.parametrize("n_aggs", [1, 4])
@pytest.mark.parametrize("blocks", [1, 5])
def test_blocked_matches_pallas(rng, n, groups, n_aggs, blocks):
    gid, mask, vals = _inputs(rng, n, groups, n_aggs)
    s1, c1 = relagg_pallas(jnp.asarray(gid), jnp.asarray(mask), jnp.asarray(vals),
                           groups, block_rows=256, interpret=True)
    s2, c2 = _blocked(gid, mask, vals, groups, blocks)
    np.testing.assert_allclose(s2, np.asarray(s1), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(c2, np.asarray(c1))


@pytest.mark.parametrize("n", [1000, 100_000])
@pytest.mark.parametrize("groups", [1, 7, 25, 1000])
@pytest.mark.parametrize("blocks", [1, 13, 132])
def test_blocked_within_one_ulp_of_float64(rng, smoke, n, groups, blocks):
    gid, mask, vals = _inputs(rng, n, groups, 3, outside=0.05)
    sums, counts = _blocked(gid, mask, vals, groups, blocks)
    ref_sums, ref_counts = _f64(gid, mask, vals, groups)
    assert smoke.f32_ulps(sums, ref_sums.astype(np.float32)).max() <= 1
    np.testing.assert_array_equal(counts, ref_counts.astype(np.float32))


@pytest.mark.parametrize("groups", [1, 25, 150_000])
def test_blocked_counts_independent_of_blocks(rng, groups):
    gid, mask, vals = _inputs(rng, 50_000, groups, 2, outside=0.1)
    counts = [_blocked(gid, mask, vals, groups, b)[1] for b in (1, 2, 16, 132, 1000)]
    for c in counts[1:]:
        np.testing.assert_array_equal(c, counts[0])
    assert counts[0].sum() == (mask & (gid >= 0) & (gid < groups)).sum()


def test_blocked_empty_mask_and_no_rows():
    gid = np.zeros(100, np.int32)
    vals = np.ones((100, 2), np.float32)
    s, c = _blocked(gid, np.zeros(100, bool), vals, 4, 7)
    assert not s.any() and not c.any()
    s, c = _blocked(gid[:0], np.zeros(0, bool), vals[:0], 4, 1)
    assert s.shape == (4, 2) and not s.any() and not c.any()


@pytest.mark.parametrize("n,blocks", [(0, 1), (1, 1), (16, 1), (17, 2), (8200, 2),
                                      (6_000_000, 132), (6_000_001, 132), (100, 132)])
def test_rows_per_block_covers_every_row_once(n, blocks):
    per = rows_per_block(n, blocks)
    assert per % 16 == 0 and per * blocks >= n
    covered = np.zeros(n, int)
    for b in range(blocks):
        covered[min(n, b * per):min(n, (b + 1) * per)] += 1
    assert (covered == 1).all()


def _smem(G, k):
    # every warp's float64 slots, its 512-row list, the id and lanes of each
    # of its 32 rows' groups, and their staged vals
    return 16 * (G * (k + 1) * 8 + 512 * 4 + 32 * 8 + 32 * k * 4)


@pytest.mark.parametrize("n,G,k,shared,grid,per_block,smem,scratch_bytes", [
    # TPC-H SF 1 Q12 and Q5, as the main path hands them to relagg
    # (132 blocks' partials and 11 groups' sums)
    (6_000_000, 7, 4, True, 132, 45_456, _smem(7, 4), 143 * 35 * 8),
    (6_000_000, 25, 2, True, 132, 45_456, _smem(25, 2), 143 * 75 * 8),
    # c_name's 150,000 codes: the global path, one float64 accumulator and
    # the warps' lists
    (6_000_000, 150_000, 1, False, 132, 45_456, 16 * 512 * 4, 150_000 * 2 * 8),
    # the largest G at k = 1 whose warps' slots fit, and the next one
    (100_000, 755, 1, True, 13, 7_696, _smem(755, 1), (13 + 2) * 1_510 * 8),
    (100_000, 756, 1, False, 13, 7_696, 16 * 512 * 4, 1_512 * 8),
    # small and empty inputs: one block
    (64, 1, 1, True, 1, 64, _smem(1, 1), 2 * 16),
    (257, 130, 8, True, 1, 272, _smem(130, 8), 2 * 130 * 9 * 8),
    (0, 7, 4, True, 1, 0, _smem(7, 4), 2 * 35 * 8),
])
def test_launch_plan(n, G, k, shared, grid, per_block, smem, scratch_bytes):
    plan = launch_plan(H100_SMS, H100_SMEM, n, G, k)
    assert (plan.shared, plan.grid, plan.per_block, plan.smem, plan.scratch_slots * 8) == \
        (shared, grid, per_block, smem, scratch_bytes)


@pytest.mark.parametrize("sms,budget", [(132, H100_SMEM), (114, H100_SMEM), (108, 166_912),
                                        (1, 48 * 1024)])
@pytest.mark.parametrize("n", [1, 10_000, 6_000_000])
@pytest.mark.parametrize("G,k", [(7, 4), (130, 8), (2_000, 1)])
def test_launch_plan_follows_the_device(sms, budget, n, G, k):
    """One block an SM at most, and no more blocks than MIN_ROWS_PER_BLOCK
    rows or part of them each; every row in a block; the shared path
    exactly where its shared memory fits the budget."""
    plan = launch_plan(sms, budget, n, G, k)
    assert 1 <= plan.grid <= sms
    assert n > MIN_ROWS_PER_BLOCK * (plan.grid - 1)
    assert plan.per_block * plan.grid >= n > plan.per_block * (plan.grid - 1)
    assert plan.shared == (shared_bytes(G, k) <= budget)
    assert plan.smem == (shared_bytes(G, k) if plan.shared else GLOBAL_SMEM)
    slots = G * (k + 1)
    groups = -(-plan.grid // BLOCK_GROUP)
    assert plan.scratch_slots == ((plan.grid + groups) * slots if plan.shared else slots)


def test_binding_constants_are_the_source_s():
    src = (ROOT / "src" / "repro_torch" / "csrc" / "relagg.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == THREADS
    assert int(re.search(r"constexpr int kList = (\d+);", src).group(1)) == LIST
    assert int(re.search(r"constexpr int kGroup = (\d+);", src).group(1)) == BLOCK_GROUP
    assert WARPS == THREADS // 32


@pytest.mark.parametrize("a,b,ulps", [
    (1.0, 1.0, 0), (1.0, np.nextafter(np.float32(1), np.float32(2)), 1),
    (0.0, -0.0, 0), (np.float32(1e-45), np.float32(-1e-45), 2), (-2.0, -2.0, 0),
    (1.0, np.float32(1) + np.float32(2.0 ** -22), 2), (-1.0, 1.0, 2 * 0x3F800000),
])
def test_f32_ulps(smoke, a, b, ulps):
    assert int(smoke.f32_ulps(np.float32([a]), np.float32([b]))[0]) == ulps


@pytest.mark.parametrize("name", ["recommended", "leader_sums", "column_lanes", "one_level_sum",
                                  "two_blocks_per_sm", "probe_no_rows", "probe_no_sums",
                                  "probe_no_cross_block", "probe_no_scan"])
def test_relagg_variant_edits_apply_once(smoke, name):
    """Each edit ``chip_smoke.py --relagg-variants`` makes finds its text
    once in ``csrc/relagg.cu``."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "relagg.cu").read_text()
    same, edits, blocks_per_sm = smoke.RELAGG_VARIANTS[name]
    assert blocks_per_sm in (1, 2) and (edits or blocks_per_sm > 1)
    for old, new in edits:
        assert src.count(old) == 1 and old != new
