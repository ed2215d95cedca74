"""The bounds that ``chip_smoke.py`` prints beside the LM kernels' times,
counted here on the CPU.  ``chip_smoke.py`` is loaded by path; at its top
it imports numpy and the standard library only.

- flash_attention: ``valid_pairs`` is the number of (query, key) pairs the
  plain version's mask (``kernels/flash_attention/ref.py::_mask``) lets
  through, over causal, window, ``q_offset`` and ragged shapes.
- ssd_scan: ``ssd_ops_needed`` is least at chunk 1 and grows with the
  chunk at the serving path's lengths, and the bound ``ssd_bound`` takes
  the function's shapes only, nothing of the kernel (its chunk).
"""
import ast
import importlib.util
import inspect
import pathlib

import numpy as np
import pytest

from repro_torch.kernels.flash_attention.ref import _mask

ROOT = pathlib.Path(__file__).resolve().parents[1]
# mamba2-370m's first prefill batch: 4 rows x 32 heads, one group a row,
# P = 64, N = 128; its two prefill batches are padded to 1,819 and 985
MAMBA = {"BH": 128, "BG": 4, "P": 64, "N": 128}
SERVING_LENGTHS = (1819, 985)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _brute_pairs(Sq, Sk, causal, window, q_offset):
    return int(_mask(Sq, Sk, causal, window, q_offset, "cpu").sum())


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (64, 64, True, None, 0),
    (100, 100, False, None, 0),
    (1819, 1819, True, None, 0),   # granite-3-2b's first prefill batch
    (96, 160, True, None, 0),      # lengths the 64-row tiles do not divide
    (160, 96, True, None, 0),      # Sq > Sk
    (200, 200, True, 16, 0),
    (200, 200, False, 16, 0),      # a window without the causal mask
    (1, 512, True, None, 511),     # a decode row
    (70, 333, True, None, 263),    # a chunked prefill's offset
    (64, 100, False, 20, 90),      # rows 29-63 see no key
    (4, 512, True, 4, 600),        # no row sees a key
    (30, 50, True, 1, 10),         # a window of one key
])
def test_valid_pairs_matches_plain_mask(smoke, Sq, Sk, causal, window, q_offset):
    assert smoke.valid_pairs(Sq, Sk, causal, window, q_offset) == \
        _brute_pairs(Sq, Sk, causal, window, q_offset)


def test_valid_pairs_matches_plain_mask_random(smoke):
    rng = np.random.default_rng(0)
    for _ in range(200):
        Sq, Sk = (int(x) for x in rng.integers(1, 300, 2))
        causal = bool(rng.integers(2))
        window = None if rng.integers(2) else int(rng.integers(1, 200))
        q_offset = int(rng.integers(0, 400))
        assert smoke.valid_pairs(Sq, Sk, causal, window, q_offset) == \
            _brute_pairs(Sq, Sk, causal, window, q_offset), (Sq, Sk, causal, window, q_offset)


def test_flash_bound_at_granite_prefill(smoke):
    """4 D operations per valid pair over B 4 x Hq 32 at D 64: 54.24 GFLOP,
    0.0548 ms at the bf16 tensor-core peak."""
    ops = 4 * 64 * smoke.valid_pairs(1819, 1819, True, None, 0) * 4 * 32
    assert ops == 1819 * 1820 // 2 * 4 * 32 * 4 * 64 == 54_240_542_720
    assert ops / smoke.BF16_OPS_PER_S * 1e3 == pytest.approx(0.05484, abs=1e-5)


@pytest.mark.parametrize("L", SERVING_LENGTHS)
def test_ssd_ops_least_at_chunk_one_and_grow_with_chunk(smoke, L):
    ops = {q: smoke.ssd_ops_needed(MAMBA["BH"], MAMBA["BG"], L, MAMBA["P"], MAMBA["N"], q)
           for q in range(1, L + 1)}
    assert all(ops[1] < ops[q] for q in range(2, L + 1))
    chunks = (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert all(ops[a] < ops[b] for a, b in zip(chunks, chunks[1:]))


def test_ssd_ops_at_chunk_one_is_the_recurrence(smoke):
    """Per row: C_i . B_i once per group (N), per head its product with xdt
    (P), C S after the first row and the state update before the last
    (N P each), two operations per multiply-add."""
    for BH, BG, L, P, N in ((128, 4, 1819, 64, 128), (8, 2, 65, 16, 16), (4, 4, 1, 64, 128)):
        want = 2 * (BG * L * N + BH * (L * P + 2 * (L - 1) * N * P))
        assert smoke.ssd_ops_needed(BH, BG, L, P, N, 1) == want


def test_ssd_bound_takes_no_kernel_argument(smoke):
    assert list(inspect.signature(smoke.ssd_bound).parameters) == ["BH", "BG", "L", "P", "N"]
    assert smoke.SSD_BOUND_CHUNK == 1
    tree = ast.parse(inspect.getsource(smoke.time_ssd))
    called = {n.func.id for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                for a in n.names}
    assert "ssd_bound" in called
    assert "ssd_ops_needed" not in called and "chunk" not in called | imported


def test_ssd_bound_at_mamba_prefill(smoke):
    ops, nbytes = smoke.ssd_bound(MAMBA["BH"], MAMBA["BG"], 1819, MAMBA["P"], MAMBA["N"])
    assert ops == 7_656_909_824
    assert nbytes == 4 * (2 * 128 * 1819 * 64 + 128 * 1819 + 2 * 4 * 1819 * 128)
    assert ops / smoke.F32_OPS_PER_S * 1e3 == pytest.approx(0.11428, abs=1e-5)


def test_ssd_bound_refuses_a_shape_where_another_chunk_is_cheaper(smoke):
    """At L = 100 one quadratic chunk needs fewer operations than the
    recurrence, so chunk 1 would not give a least time."""
    with pytest.raises(RuntimeError, match="needs fewer"):
        smoke.ssd_bound(MAMBA["BH"], MAMBA["BG"], 100, MAMBA["P"], MAMBA["N"])
