"""The bounds that ``chip_smoke.py`` prints beside the LM kernels' times,
counted here on the CPU.  ``chip_smoke.py`` is loaded by path; at its top
it imports numpy and the standard library only.

- flash_attention: ``valid_pairs`` is the number of (query, key) pairs the
  plain version's mask (``kernels/flash_attention/ref.py::_mask``) lets
  through, over causal, window, ``q_offset`` and ragged shapes.
- ssd_scan: ``ssd_ops_needed`` is least at chunk 1 and grows with the
  chunk at the serving path's lengths, and the bound ``ssd_bound`` takes
  the function's shapes only, nothing of the kernel (its chunk).

Beside the bounds, helpers its checks rest on: the head dim read from a
flash kernel's name, the capture of the longest serving call of each kind
(gemma3's local and global layers), and the source edits its
``--flash-variants`` mode builds.
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


@pytest.mark.parametrize("B,Hq,D,window,ops,ms", [
    (4, 32, 96, None, 81_360_814_080, 0.08227),    # phi3-mini-3.8b, MHA
    (4, 16, 256, None, 108_481_085_440, 0.10969),  # gemma3-12b, a global layer
    (4, 16, 256, 1024, 87_744_839_680, 0.08872),   # gemma3-12b, a local layer
])
def test_flash_bound_at_phi3_and_gemma3_prefill(smoke, B, Hq, D, window, ops, ms):
    """4 D operations per valid pair at the first 1,819-token prefill batch;
    a local layer's 1,024-key window lets 1,338,880 pairs through per
    (batch, head) instead of 1,655,290."""
    pairs = smoke.valid_pairs(1819, 1819, True, window, 0)
    assert pairs == (1_655_290 if window is None else 1_338_880)
    assert 4 * D * pairs * B * Hq == ops
    assert ops / smoke.BF16_OPS_PER_S * 1e3 == pytest.approx(ms, abs=1e-5)


@pytest.mark.parametrize("name,D", [
    ("tc::flash_fwd_bf16<96>", 96),
    ("_ZN12_GLOBAL__N_12tc14flash_fwd_bf16ILi256EEEvNS_4ArgsE", 256),
    ("tc::flash_fwd_bf16<16>", 16),
    ("<unnamed>::tc::flash_fwd_bf16<(int)128>", 128),   # as cu++filt prints it
])
def test_flash_head_dim_from_the_kernel_name(smoke, name, D):
    assert smoke.flash_head_dim(name) == D


@pytest.mark.parametrize("name,kernel,D", [
    ("<unnamed>::bwd::flash_bwd_dkdv_bf16<(int)96>", "flash_bwd_dkdv_bf16", 96),
    ("bwd::flash_bwd_dq_bf16<16>", "flash_bwd_dq_bf16", 16),
    ("_ZN12_GLOBAL__N_13bwd17flash_bwd_dq_bf16ILi128EEEvNS0_8BwdArgsE", "flash_bwd_dq_bf16",
     128),
])
def test_flash_backward_head_dim_from_the_kernel_name(smoke, name, kernel, D):
    """The build report reads the tensor-core backward instances' head dims
    from their names, as it reads the forward's."""
    assert kernel in smoke.FLASH_BWD_TC
    assert smoke.flash_head_dim(name, kernel) == D


def test_longest_call_keeps_each_kind(smoke):
    """The capture keeps the longest windowed call and the longest call
    without a window apart (gemma3's local and global layers), and counts
    the calls of each kind."""
    seen = []
    capture = smoke.LongestCall(lambda *a, **kw: seen.append(a[0].shape) or a[0], 2)
    for S, window in ((100, 1024), (300, None), (200, 1024), (50, None), (150, 1024)):
        capture(np.zeros((1, 2, S, 4)), causal=True, window=window)
    assert len(seen) == 5
    assert {kind: args[0].shape[2] for kind, (args, _) in capture.calls.items()} == \
        {"window": 200, "full": 300}
    assert capture.calls["window"][1] == {"causal": True, "window": 1024}
    assert capture.counts == {"window": 3, "full": 2}


@pytest.mark.parametrize("name", ["d96_one_warpgroup", "early_copies", "ex2_approx"])
def test_flash_variant_edits_apply_once(smoke, name):
    """Each edit ``--flash-variants`` makes finds its text once in
    ``csrc/flash_attention.cu``, so the variant differs from the shipped
    source in that place alone."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu").read_text()
    for old, new in smoke.FLASH_VARIANTS[name]:
        assert src.count(old) == 1 and old != new


def test_mesh_fused_specs_are_the_sharded_tests_specs(smoke):
    """The mesh phase's (b) drains ``tests/test_fused.py:434-457``'s
    mixed-divisibility spec and the padded one the port's sharded tests
    hold to the reference's figures."""
    from test_torch_sharded_many import FUSED_SPECS

    assert smoke.MESH_FUSED_SPECS == {"mixed_divisibility": FUSED_SPECS["fused_mixed"],
                                      "padded": FUSED_SPECS["fused_padded"]}


def test_mesh_phase_rehearsal(smoke):
    """``mesh_run`` on the CPU at 3,000 ``detail`` rows: every check of
    (a)-(e) passes on meshes naming the CPU 2 and 4 times."""
    out = smoke.mesh_run("cpu", 3000, 3000, (32,), 1, timed=False)
    row = out["key_total"][32]
    assert [row[x]["shard_devices"] for x in ("unsharded", "x2", "x4")] == [1, 2, 4]
    assert row["x2"]["bit_equal_to_unsharded"] and row["x4"]["bit_equal_to_unsharded"]
    assert row["shard_hits_warm_calls"] == 2
    assert out["fused"]["padded"]["buckets"] == [1, 4, 8]
    assert out["intake"]["flush_size"] == 8
    assert out["store"]["B"]["persist_hits"] == 2 and out["store"]["A"]["shard_entry"]
    assert out["routed"]["sharded"] and out["routed"]["many_keys"] >= 1


def test_ssd_bwd_bound_at_mamba_training(smoke):
    """The reverse recurrence's 10 N P operations a row and head (2.5x the
    forward's 4 N P; ddtA is a reverse cumsum of O(P) a row) at
    mamba2-370m's training inputs (a microbatch of 2 x 4,096 tokens: 64
    heads, 2 groups), and its bytes, each input and gradient once."""
    BH, BG, L, P, N = 64, 2, 4096, 64, 128
    ops, nbytes = smoke.ssd_bwd_bound(BH, BG, L, P, N)
    assert ops == 21_474_836_480 == 5 * 2 * N * P * L * BH
    assert nbytes == 4 * (3 * BH * L * P + 2 * BH * L + 4 * BG * L * N)
    assert ops / smoke.F32_OPS_PER_S * 1e3 == pytest.approx(0.32052, abs=1e-5)
    assert list(inspect.signature(smoke.ssd_bwd_bound).parameters) == ["BH", "BG", "L", "P",
                                                                        "N"]


def test_ssd_backward_sweep_covers_the_forward_sweep(smoke):
    """(f) runs every shape of the forward's sweep, L = 1 and 70,000 heads
    among them, mamba2-370m's training inputs, 3 heads a group (which
    ``ssd_bwd_chunk_dbc``'s slices of 8 do not divide) and N = 256."""
    shapes = {case[:5] for case in smoke.SSD_BWD_CASES}
    assert set(smoke.SSD_CASES) <= shapes
    assert (64, 2, 4096, 64, 128) in shapes
    assert any(case[2] == 1 for case in shapes) and any(case[0] == 70_000 for case in shapes)
    assert any(BH // BG == 3 for BH, BG, *_ in shapes)
    assert any(N == 256 for *_, N in shapes)


def test_ssd_bwd_kernel_bounds_at_mamba_training(smoke):
    """Each backward kernel's own bound at mamba2-370m's training inputs:
    dB and dC 4 N P a row and head (8.59 GFLOP, 0.128 ms at 67 TFLOP/s),
    dxdt and dS_in 2 N P each (4.29 GFLOP, 0.064 ms), the rest no
    operations; together at most the whole backward's 10 N P; 3xTF32's
    rate only for the two tensor-core kernels."""
    BH, BG, L, P, N = 64, 2, 4096, 64, 128
    b = smoke.ssd_bwd_kernel_bounds(BH, BG, L, P, N)
    assert set(b) == {"ssd_bwd_dstate", "ssd_bwd_state_pass", "ssd_bwd_chunk_dx",
                      "ssd_bwd_chunk_dbc", "ssd_bwd_dbc_sum", "ssd_bwd_ddtA"}
    dbc, dx = b["ssd_bwd_chunk_dbc"], b["ssd_bwd_chunk_dx"]
    assert dbc["ops"] == 8_589_934_592 and dx["ops"] == b["ssd_bwd_dstate"]["ops"] == 4_294_967_296
    assert dbc["bound_ms"] == pytest.approx(0.1282, abs=1e-4) and dbc["bound_by"] == "operations"
    assert dx["bound_ms"] == pytest.approx(0.0641, abs=1e-4) and dx["bound_by"] == "operations"
    assert dbc["tf32x3_ms"] == pytest.approx(8_589_934_592 / 165e12 * 1e3)
    assert dx["tf32x3_ms"] == pytest.approx(dx["bytes"] / 3.35e12 * 1e3)  # bytes bound it there
    assert dbc["bytes"] == 4 * (2 * BH * L * P + BH * L + 2 * BG * L * N)
    assert all(b[k]["tf32x3_ms"] is None for k in b if k not in smoke.SSD_BWD_TC)
    whole_ops, _ = smoke.ssd_bwd_bound(BH, BG, L, P, N)
    assert sum(k["ops"] for k in b.values()) <= whole_ops
    assert b["ssd_bwd_state_pass"]["ops"] == 0 and b["ssd_bwd_state_pass"]["bytes"] > 0


@pytest.mark.parametrize("control,module,name,n_grads", [
    ("_flash_dk_zeroed", "repro_torch.kernels.flash_attention.flash_attention",
     "flash_attention_bwd_cuda", 3),
    ("_ssd_ddtA_zeroed", "repro_torch.kernels.ssd_scan.ssd_scan", "ssd_scan_bwd_cuda", 4),
])
def test_smoke_training_controls(smoke, monkeypatch, control, module, name, n_grads):
    """(d)'s and (i)'s controls zero the second gradient of the backward
    binding they wrap (dK of dQ, dK, dV; ddtA of dxdt, ddtA, dB, dC), pass
    the others through, and put the binding back."""
    import torch

    binding = importlib.import_module(module)
    grads = tuple(torch.full((2, 3), float(i + 1)) for i in range(n_grads))
    monkeypatch.setattr(binding, name, lambda *args, **kw: grads)
    stub = getattr(binding, name)
    with getattr(smoke, control)():
        got = getattr(binding, name)(None)
    assert getattr(binding, name) is stub
    for i, (g, w) in enumerate(zip(got, grads)):
        assert torch.equal(g, torch.zeros_like(w) if i == 1 else w)


def test_plain_ssd_backward_stands_in_for_the_binding(smoke):
    """(g)'s exact-gradient runs put ``_plain64_ssd_backward`` in the ssd
    backward binding's place: it takes the binding's arguments and returns
    ``ssd_scan_bwd_ref`` in float64, rounded to float32."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref

    binding = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    assert (list(inspect.signature(smoke._plain64_ssd_backward).parameters)
            == list(inspect.signature(binding.ssd_scan_bwd_cuda).parameters))
    rng = np.random.default_rng(7)
    xdt, dy = (torch.as_tensor(rng.normal(size=(4, 70, 8)), dtype=torch.float32)
               for _ in range(2))
    dtA = torch.as_tensor(-rng.uniform(0.01, 0.5, size=(4, 70)), dtype=torch.float32)
    B, C = (torch.as_tensor(rng.normal(size=(2, 70, 16)) * 0.3, dtype=torch.float32)
            for _ in range(2))
    got = smoke._plain64_ssd_backward(xdt, dtA, B, C, 2, None, None, None, None, dy)
    want = ssd_scan_bwd_ref(*(t.double() for t in (xdt, dtA, B, C)), 2, dy.double())
    assert all(g.dtype == torch.float32 and torch.equal(g, w.float()) for g, w in zip(got, want))
