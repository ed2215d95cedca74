"""The port's relagg plain version against the JAX kernel (Pallas in
interpret mode, as ``tests/test_kernels.py`` runs it), on the reference's
own sweep; and the CUDA kernel against the plain version on the card.

Sums match to rtol/atol 1e-4 (the reference's bound,
``tests/test_kernels.py:25``); counts add exact 1.0s and match exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.relagg.relagg import relagg_pallas
from repro_torch.kernels.relagg import ops
from repro_torch.kernels.relagg.ref import grouped_aggregate_ref
from repro_torch.kernels.relagg.relagg import relagg_cuda


def _both(gid, mask, vals, groups, block_rows=256):
    s1, c1 = relagg_pallas(jnp.asarray(gid), jnp.asarray(mask), jnp.asarray(vals),
                           groups, block_rows=block_rows, interpret=True)
    s2, c2 = grouped_aggregate_ref(torch.as_tensor(gid), torch.as_tensor(mask),
                                   torch.as_tensor(vals), groups)
    return (np.asarray(s1), np.asarray(c1)), (s2.numpy(), c2.numpy())


@pytest.mark.parametrize("n", [64, 257, 1000, 4096])
@pytest.mark.parametrize("groups", [1, 8, 130])
@pytest.mark.parametrize("n_aggs", [1, 4])
def test_relagg_plain_matches_pallas(rng, n, groups, n_aggs):
    gid = rng.integers(0, groups, n).astype(np.int32)
    mask = rng.random(n) > 0.4
    vals = rng.normal(size=(n, n_aggs)).astype(np.float32)
    (s1, c1), (s2, c2) = _both(gid, mask, vals, groups)
    np.testing.assert_allclose(s2, s1, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(c2, c1)


def test_relagg_plain_empty_mask():
    gid = np.zeros(128, np.int32)
    mask = np.zeros(128, bool)
    vals = np.ones((128, 2), np.float32)
    (s1, c1), (s2, c2) = _both(gid, mask, vals, 4, block_rows=128)
    assert np.abs(s2).sum() == 0.0 and c2.sum() == 0.0
    np.testing.assert_array_equal(s2, s1)
    np.testing.assert_array_equal(c2, c1)


@pytest.mark.parametrize("masked", [True, False])
def test_relagg_plain_out_of_range_gids(rng, masked):
    """Rows whose gid lies outside [0, G) add nothing, whether the mask
    drops them or not (on the TPU they hit no one-hot column)."""
    n, groups = 300, 5
    gid = rng.integers(-7, groups + 7, n).astype(np.int32)
    outside = (gid < 0) | (gid >= groups)
    mask = rng.random(n) > 0.3
    if masked:
        mask &= ~outside
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    (s1, c1), (s2, c2) = _both(gid, mask, vals, groups)
    np.testing.assert_allclose(s2, s1, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(c2, c1)
    assert c2.sum() == (mask & ~outside).sum()


def test_grouped_aggregate_cpu_takes_plain_path(rng):
    gid = torch.as_tensor(rng.integers(0, 6, 200).astype(np.int32))
    mask = torch.as_tensor(rng.random(200) > 0.5)
    vals = torch.as_tensor(rng.normal(size=(200, 2)).astype(np.float32))
    before = ops.LAUNCHES
    s, c = ops.grouped_aggregate(gid, mask, vals, 6)
    s2, c2 = grouped_aggregate_ref(gid, mask, vals, 6)
    assert ops.LAUNCHES == before
    assert torch.equal(s, s2) and torch.equal(c, c2)


def test_grouped_aggregate_rejects_other_devices():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.grouped_aggregate(t, t.bool(), torch.zeros((4, 1), device="meta"), 2)


def test_relagg_cuda_rejects_host_tensors():
    with pytest.raises(ValueError):
        relagg_cuda(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.bool),
                    torch.zeros((4, 1)), 2)
