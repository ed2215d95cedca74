"""The relagg CUDA kernel against its plain torch version, and the port's
TPC-H path on the card against the same path on the CPU.  These need an
NVIDIA GPU with ``nvcc`` and skip elsewhere; on the card they run with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_relagg_card.py

Counts add exact 1.0s and match exactly; sums differ by the order the
float atomics land in and match to rtol/atol 1e-4."""
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
