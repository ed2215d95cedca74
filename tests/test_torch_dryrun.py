"""The port's dry run (``repro_torch.launch.dryrun``, ``report``,
``roofline``) and what it stands on, on the CPU.

- The model zoo's ``meta`` stand-ins against the reference's abstract
  trees on every architecture and shape: ``init_shapes`` (after stacking
  the port's per-repeat blocks), ``input_specs`` (tokens, labels, memory;
  a decode cache leaf by leaf after the same stacking), ``memory_len_for``,
  ``shape_supported``, ``auto_microbatches`` at dp 16 and 32 (the
  reference's own function, read from its source without importing its
  module, which sets ``XLA_FLAGS`` at import), ``model_flops_train`` and
  ``model_flops_decode``.
- The kernels' fake versions: ``FlopCounterMode`` of ``flash_attention``
  and ``ssd_scan`` on ``meta`` against the counts of ``launch/roofline.py``
  (flash's forward 4 D valid pairs B Hq, its backward 2.5 times that;
  ssd's forward ``ssd_ops_needed`` at the kernels' chunk of 64, its
  backward ``ssd_bwd_kernel_ops``); each fake's outputs against the plain
  version's outputs and gradients on the CPU (shapes, dtypes, strides);
  ``ssd_bwd_kernel_ops`` at chunk 1 and its growth with the chunk.
- ``Roofline`` at the H100's peaks; ``collectives_from_specs`` on a tree of
  two leaves counted by hand.
- The dry run itself: the 80 cells' skips without tracing, a few cells
  traced at full width in-process, one through the command line in a
  subprocess, the report on its records; ``StepTrace``'s flops against
  ``FlopCounterMode``; the mamba prefill's cache holding no view of a
  larger tensor (C14).
"""
import ast
import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS, config_for
from repro.launch import roofline as RR
from repro.models import build_model as ref_build
from repro.models import input_specs as ref_input_specs
from repro.models import model_zoo as RZ
from repro.models.config import SHAPES
from repro_torch.configs import config_for as port_config_for
from repro_torch.configs import smoke_config_for
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_state_passing
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as PR
from repro_torch.launch import roofline as PRL
from repro_torch.models import build_model, input_specs
from repro_torch.models import model_zoo as PZ
from repro_torch.models.config import SHAPES as PORT_SHAPES
from repro_torch.tree import stack_blocks, tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
# by path: the package's own ``ssd_scan`` is the ops function
ssd_binding = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
FULL_ATTENTION = {"llama32_vision_90b", "granite3_2b", "minicpm3_4b", "phi3_mini_38b",
                  "granite_moe_3b_a800m", "seamless_m4t_large_v2"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32,
          "int8": torch.int8}


def _paths(tree, path=()):
    """``{path: leaf}`` of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, path + (k,)))
    return out


def _same_abstract(ref_tree, port_tree):
    ref, port = _paths(ref_tree), _paths(port_tree)
    assert ref.keys() == port.keys()
    for k, r in ref.items():
        p = port[k]
        assert p.device.type == "meta", k
        assert tuple(p.shape) == tuple(r.shape), k
        assert p.dtype == DTYPES[str(np.dtype(r.dtype))], k


def _stack_cache(cache):
    """The port's cache as the reference lays it out: ``layers`` stacked
    along a leading repeat axis, ``pos`` left out."""
    layers = cache["layers"]
    return {name: {kind: tuple(torch.stack([blk[name][kind][j] for blk in layers])
                               for j in range(len(parts)))
                   if isinstance(parts, tuple) else torch.stack([blk[name][kind]
                                                                 for blk in layers])
                   for kind, parts in entry.items()}
            for name, entry in layers[0].items()}


# ---------------------------------------------------------------------------
# the model zoo's stand-ins against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_shapes_equal_the_reference(arch):
    port = build_model(port_config_for(arch), "meta").init_shapes()
    _same_abstract(ref_build(config_for(arch)).init_shapes(), stack_blocks(port))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape):
    ref = ref_input_specs(config_for(arch), SHAPES[shape])
    port = input_specs(port_config_for(arch), shape)
    assert ref.keys() == port.keys()
    if "cache" in ref:
        cache = port.pop("cache")
        assert cache["pos"] == 0
        _same_abstract(ref["cache"]["layers"], _stack_cache(cache))
        ref = {k: v for k, v in ref.items() if k != "cache"}
    _same_abstract(ref, port)


def _reference_auto_microbatches():
    """The reference's ``auto_microbatches`` and its budget, compiled from
    its source alone (importing ``repro.launch.dryrun`` would set
    ``XLA_FLAGS`` for every later JAX initialisation in this process)."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "RESIDUAL_BUDGET")
            or (isinstance(n, ast.FunctionDef) and n.name == "auto_microbatches")]
    assert len(keep) == 2
    ns = {}
    exec(compile(ast.Module(keep, []), str(path), "exec"), ns)
    return ns["auto_microbatches"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_helpers_equal_the_reference(arch):
    ref_cfg, cfg = config_for(arch), port_config_for(arch)
    ref_auto = _reference_auto_microbatches()
    for name in SHAPES:
        assert PZ.memory_len_for(cfg, PORT_SHAPES[name]) == \
            RZ.memory_len_for(ref_cfg, SHAPES[name])
        assert PZ.shape_supported(cfg, PORT_SHAPES[name]) == \
            RZ.shape_supported(ref_cfg, SHAPES[name])
        for dp in (16, 32):
            assert D.auto_microbatches(cfg, PORT_SHAPES[name], dp) == \
                ref_auto(ref_cfg, SHAPES[name], dp)
        for tokens in (1, 128, 4096 * 256):
            assert PRL.model_flops_train(cfg, tokens) == RR.model_flops_train(ref_cfg, tokens)
            assert PRL.model_flops_decode(cfg, tokens) == \
                RR.model_flops_decode(ref_cfg, tokens)
    assert PZ.AUDIO_DECODE_MEMORY == RZ.AUDIO_DECODE_MEMORY


def test_granite_train_4k_picks_8_microbatches():
    cfg = port_config_for("granite3_2b")
    assert D.auto_microbatches(cfg, PORT_SHAPES["train_4k"], 16) == 8


# ---------------------------------------------------------------------------
# the kernels' fake versions and flop formulas
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# (B, Hq, Hk, Sq, Sk, D, causal, window, q_offset)
FLASH_FLOP_CASES = [
    (2, 8, 2, 100, 100, 64, True, None, 0),       # causal GQA
    (1, 4, 4, 200, 200, 96, True, 16, 0),         # a window
    (2, 4, 1, 3, 500, 128, True, None, 497),      # a chunk's q_offset
    (2, 4, 4, 70, 333, 256, False, None, 0),      # no mask (cross-attention)
    (1, 2, 2, 50, 50, 16, False, 20, 30),         # window without the mask
]


@pytest.mark.parametrize("case", FLASH_FLOP_CASES)
def test_flash_flop_formula(case):
    B, Hq, Hk, Sq, Sk, Dh, causal, window, q_offset = case
    q = _meta(B, Hq, Sq, Dh, grad=True)
    k, v = _meta(B, Hk, Sk, Dh, grad=True), _meta(B, Hk, Sk, Dh, grad=True)
    want = 4 * Dh * PRL.valid_pairs(Sq, Sk, causal, window, q_offset) * B * Hq
    assert want == PRL.flash_ops(B, Hq, Sq, Sk, Dh, causal, window, q_offset)
    with FlopCounterMode(display=False) as fc:
        o = fa_ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
        forward = fc.get_total_flops()
        o.sum().backward()
    assert forward == want
    assert fc.get_total_flops() - forward == 2.5 * want == \
        PRL.flash_bwd_ops(B, Hq, Sq, Sk, Dh, causal, window, q_offset)
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_flash_flop_formula_at_padded_head_dims():
    """MLA's v zero-padded to q's head dim (minicpm3: 64 to 96) is counted
    at 96; a head dim between instances (24) at the instance it is padded
    to (64)."""
    q, k = _meta(2, 4, 50, 96), _meta(2, 4, 50, 96)
    v = F.pad(_meta(2, 4, 50, 64), (0, 32))
    with FlopCounterMode(display=False) as fc:
        fa_ops.flash_attention(q, k, v)
    assert fc.get_total_flops() == 4 * 96 * PRL.valid_pairs(50, 50, True, None, 0) * 2 * 4
    q = _meta(2, 4, 50, 24)
    with FlopCounterMode(display=False) as fc:
        out = fa_ops.flash_attention(q, q, q)
    assert out.shape == q.shape
    assert fc.get_total_flops() == 4 * 64 * PRL.valid_pairs(50, 50, True, None, 0) * 2 * 4
    assert min(d for d in HEAD_DIMS if d >= 24) == 64
    with pytest.raises(ValueError, match="above every compiled"):
        fa_ops.flash_attention(_meta(1, 1, 4, 300), _meta(1, 1, 4, 300), _meta(1, 1, 4, 300))


@pytest.mark.parametrize("BH,BG,L,P,N", [(8, 2, 300, 16, 16), (4, 4, 64, 64, 128),
                                         (32, 1, 130, 64, 128), (6, 3, 1, 16, 32)])
def test_ssd_flop_formula(BH, BG, L, P, N):
    Bb, H, G = BG, BH // BG, 1
    x = _meta(Bb, L, H, P, dtype=torch.float32, grad=True)
    dt, A = _meta(Bb, L, H, dtype=torch.float32), _meta(H, dtype=torch.float32)
    B, C = _meta(Bb, L, G, N, dtype=torch.float32), _meta(Bb, L, G, N, dtype=torch.float32)
    with FlopCounterMode(display=False) as fc:
        y = ssd_ops.ssd_scan(x, dt, A, B, C)
        forward = fc.get_total_flops()
        y.sum().backward()
    assert forward == PRL.ssd_ops_needed(BH, BG, L, P, N, 64)
    assert fc.get_total_flops() - forward == PRL.ssd_bwd_kernel_ops(
        BH, BG, L, P, N, 64, ssd_binding.bwd_slices(H))
    assert x.grad.shape == x.shape


def test_ssd_bwd_kernel_ops_at_chunk_one_and_with_the_chunk():
    """At chunk 1 each row is its own chunk: per head 2 P (the score and D
    products) and 4 N P but at the first and last rows, per group and slice
    2 N, two operations a multiply-add; the triangles grow with the chunk
    at mamba2-370m's training length."""
    for BH, BG, L, P, N, slices in ((64, 2, 4096, 64, 128, 4), (8, 2, 65, 16, 16, 1),
                                    (4, 4, 1, 64, 128, 1)):
        want = 2 * (BH * (2 * P * L + 4 * N * P * (L - 1)) + BG * slices * 2 * N * L)
        assert PRL.ssd_bwd_kernel_ops(BH, BG, L, P, N, 1, slices) == want
    ops = [PRL.ssd_bwd_kernel_ops(64, 2, 4096, 64, 128, q, 4) for q in (1, 8, 64, 512)]
    assert ops == sorted(ops) and len(set(ops)) == 4
    # mamba2-370m's training microbatch at the kernels' chunk: below the
    # reverse recurrence's 10 N P a row and head (the kernels read the
    # forward's states), above the forward's count
    at64 = PRL.ssd_bwd_kernel_ops(64, 2, 4096, 64, 128, 64, 4)
    assert PRL.ssd_ops_needed(64, 2, 4096, 64, 128, 64) < at64 \
        < PRL.ssd_bwd_ops_needed(64, 4096, 64, 128)


def _layout(t):
    """Shape, dtype and strides as the launches lay their outputs out:
    contiguous (a plain version may return a strided slice; ``chip_smoke.py``
    holds each fake's strides to its launch's on the card)."""
    return tuple(t.shape), t.dtype, torch.empty(t.shape, device="meta").stride()


def _fake_layout(t):
    return tuple(t.shape), t.dtype, t.stride()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (False, None, 0),
                                                    (True, 8, 5)])
def test_flash_fakes_match_the_plain_version(dtype, causal, window, q_offset):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 24, 16, generator=g).to(dtype)
    k, v = (torch.randn(2, 2, 40, 16, generator=g).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    grads = flash_attention_bwd_ref(q, k, v, o, lse, torch.ones_like(o), **kw)
    mq, mk, mv, mo, ml = (t.to("meta") for t in (q, k, v, o, lse))
    fo, fl = torch.ops.repro_torch.flash_attention_fwd(mq, mk, mv, causal, window, q_offset,
                                                       None, True)
    assert [_fake_layout(t) for t in (fo, fl)] == [_layout(t) for t in (o, lse)]
    fo, fl = torch.ops.repro_torch.flash_attention_fwd(mq, mk, mv, causal, window, q_offset,
                                                       None, False)
    assert _fake_layout(fo) == _layout(o) and fl.shape == (0,)
    fgrads = torch.ops.repro_torch.flash_attention_bwd(mq, mk, mv, mo, ml, mo, causal,
                                                       window, q_offset, None)
    assert [_fake_layout(t) for t in fgrads] == [_layout(t) for t in grads]


@pytest.mark.parametrize("BH,BG,L,P,N", [(8, 2, 130, 16, 16), (4, 4, 64, 16, 32),
                                         (3, 1, 1, 8, 8)])
def test_ssd_fakes_match_the_plain_version(BH, BG, L, P, N):
    g = torch.Generator().manual_seed(1)
    n_rep = BH // BG
    xdt = torch.randn(BH, L, P, generator=g)
    dtA = -torch.rand(BH, L, generator=g)
    B, C = torch.randn(BG, L, N, generator=g), torch.randn(BG, L, N, generator=g)
    y, s_in = ssd_scan_state_passing(xdt, dtA, B, C, n_rep, return_states=True)
    grads = ssd_scan_bwd_ref(xdt, dtA, B, C, n_rep, torch.ones_like(y))
    meta = [t.to("meta") for t in (xdt, dtA, B, C)]
    fy, cbt, states, decay = torch.ops.repro_torch.ssd_scan_fwd(*meta, n_rep)
    assert _fake_layout(fy) == _layout(y)
    nc = -(-L // 64)
    # the scratch as the binding's Plan lays it out: states past the first chunk
    assert _fake_layout(states) == _layout(s_in[:, 1:])
    assert cbt.shape == (BG, nc, 64, 64) and decay.shape == (BH, nc - 1)
    fgrads = torch.ops.repro_torch.ssd_scan_bwd(*meta, n_rep, states, decay, cbt, fy, fy)
    assert [_fake_layout(t) for t in fgrads] == [_layout(t) for t in grads]


def test_ssd_size_copies():
    """The Python copies of the library's sizes: at mamba2-370m's training
    inputs the backward's scratch is PERF.md's 167.8 MB."""
    assert ssd_binding.CHUNK == 64 and ssd_binding.SLICE_HEADS == 8
    assert [ssd_binding.bwd_slices(r) for r in (1, 8, 9, 32, 70)] == [1, 1, 2, 4, 9]
    assert ssd_binding.bwd_parts(64, 128) == 64 and ssd_binding.bwd_parts(16, 16) == 8
    xdt, B = _meta(64, 4096, 64, dtype=torch.float32), _meta(2, 4096, 128, dtype=torch.float32)
    scratch = ssd_ops.fake_backward_buffers(xdt, B, 32)[4:]
    assert sum(t.nbytes for t in scratch) == 167_755_776


def test_fakes_check_their_inputs():
    with pytest.raises(ValueError, match="head dim"):
        torch.ops.repro_torch.flash_attention_fwd(_meta(1, 2, 4, 20), _meta(1, 2, 4, 20),
                                                  _meta(1, 2, 4, 20), True, None, 0, None,
                                                  False)
    with pytest.raises(TypeError):
        torch.ops.repro_torch.ssd_scan_fwd(_meta(2, 8, 16), _meta(2, 8, dtype=torch.float32),
                                           _meta(2, 8, 16), _meta(2, 8, 16), 1)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_roofline_terms_and_dominant():
    r = PRL.Roofline(flops=989e12, hbm_bytes=3.35e12 * 2, collective_bytes=50e9, chips=256)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.dominant == "memory" and r.bound_time == pytest.approx(2.0)
    r = PRL.Roofline(flops=1, hbm_bytes=1, collective_bytes=450e9, chips=8,
                     link_bw=PRL.NVLINK_BW)
    assert r.t_collective == pytest.approx(1.0) and r.dominant == "collective"
    d = r.as_dict()
    assert d["dominant"] == "collective" and d["link_bw"] == 450e9


def test_collectives_from_specs_by_hand():
    """Two leaves on a (data 4, model 2) mesh: w (1024, 512) split on both,
    FSDP over data; a norm scale (512,) replicated.  w's slice on one
    device along model is 1024 x 256; each use all-gathers 3/4 of it in
    bf16, the gradient reduce-scatters 3/4 of it in float32."""
    from repro_torch.dist.sharding import PartitionSpec as Spec

    class StandIn:
        shape = {"data": 4, "model": 2}

    leaves = [torch.empty(1024, 512, device="meta"), torch.empty(512, device="meta")]
    specs = [Spec("data", "model"), Spec()]
    stats, bw = PRL.collectives_from_specs(leaves, specs, StandIn, uses=6, reduce_grads=True)
    assert stats.bytes_by_kind["all-gather"] == 6 * 2 * 1024 * 256 * 3 / 4
    assert stats.bytes_by_kind["reduce-scatter"] == 4 * 1024 * 256 * 3 / 4
    assert stats.count_by_kind["all-gather"] == 6 and stats.count_by_kind["reduce-scatter"] == 1
    assert stats.total_bytes == 6 * 393_216 + 786_432
    assert bw == PRL.NVLINK_BW  # 4 x 2 positions: one node
    stats, _ = PRL.collectives_from_specs(leaves, specs, StandIn, uses=1, reduce_grads=False)
    assert stats.bytes_by_kind["reduce-scatter"] == 0 and stats.count_by_kind["all-gather"] == 1

    class Production:
        shape = {"data": 16, "model": 16}

    assert PRL.link_bw_for(Production, ("data",)) == PRL.INFINIBAND_BW
    assert PRL.link_bw_for(Production, ("model",)) == PRL.INFINIBAND_BW


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_the_sweep_skips_exactly_long_500k_of_the_full_attention_archs(tmp_path, monkeypatch):
    """``--all`` writes 80 records; the skips come before any trace."""
    def no_trace(*args, **kwargs):
        raise AssertionError("a skipped cell traced")

    monkeypatch.setattr(D, "make_step", no_trace)
    monkeypatch.setattr(D.gc, "collect", lambda: 0)  # a full collection a cell is slow here
    calls, skip_cell = [], D.dryrun_cell

    def cell(arch, shape, multi, **kwargs):
        calls.append((arch, shape, multi))
        rec = {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi else "16x16",
               "status": "skip"}
        ok, why = PZ.shape_supported(port_config_for(arch), PORT_SHAPES[shape])
        if ok:
            rec["status"] = "ok-stub"
        else:
            rec.update(skip_cell(arch, shape, multi))
        return rec

    monkeypatch.setattr(D, "dryrun_cell", cell)
    D.main(["--all", "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == len(calls) == 80
    skips = {(r["arch"], r["shape"], r["mesh"]) for r in recs if r["status"] == "skip"}
    assert skips == {(a, "long_500k", m) for a in FULL_ATTENTION for m in ("16x16", "2x16x16")}
    assert all("DESIGN.md" in r["reason"] for r in recs if r["status"] == "skip")


def _check_record(rec, mesh):
    assert rec["status"] == "ok" and rec["mesh"] == mesh
    roof, mem = rec["roofline"], rec["memory"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert mem["per_device_total"] == \
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
    assert min(mem.values()) >= 0 and mem["per_device_total"] > mem["argument_bytes"]
    assert 0 < rec["useful_flop_ratio"] <= 1.0
    assert rec["model_flops_per_chip"] * roof["chips"] == rec["model_flops_global"]
    assert "derived" in rec


def test_granite_train_4k_single():
    rec = D.dryrun_cell("granite3_2b", "train_4k", False)
    _check_record(rec, "16x16")
    assert rec["microbatches"] == 8 and rec["replica_batch"] == 16
    cfg = port_config_for("granite3_2b")
    # a training step traces 8 (remat forward + forward + backward) over
    # 16 x 4,096 tokens: above 6 N D of the replica's tokens over the
    # model axis, below twice that
    flops = rec["roofline"]["flops"] * 16
    assert 6 * cfg.active_param_count() * 16 * 4096 < flops < 12 * cfg.active_param_count() \
        * 16 * 4096
    colls = rec["collectives"]
    assert colls["count"]["all-gather"] > 0 and colls["count"]["reduce-scatter"] > 0
    assert colls["bytes"]["all-reduce"] == 0


def test_seamless_prefill_32k_multi():
    rec = D.dryrun_cell("seamless_m4t_large_v2", "prefill_32k", True)
    _check_record(rec, "2x16x16")
    assert rec["replica_batch"] == 1 and rec["microbatches"] is None
    assert rec["collectives"]["bytes"]["reduce-scatter"] == 0


def test_jamba_long_500k_single():
    """One sequence: the batch is replicated over the data axes (1 does not
    divide 16), so the replica decodes the whole batch."""
    rec = D.dryrun_cell("jamba15_large_398b", "long_500k", False)
    _check_record(rec, "16x16")
    assert rec["replica_batch"] == 1 and rec["memory"]["alias_bytes"] > 0


def test_cli_cell_subprocess_and_report(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2_370m",
         "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (path,) = tmp_path.glob("*.json")
    assert path.name == "mamba2_370m.decode_32k.single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok"
    assert rec["roofline"]["flops"] > 0
    assert rec["memory"]["per_device_total"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", "--dir", str(tmp_path), "--table"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert "cells: 1  ok: 1  skip: 0  fail: 0" in proc.stdout
    assert "| mamba2_370m | decode_32k |" in proc.stdout
    assert PR.summary([rec]).splitlines()[0] == "cells: 1  ok: 1  skip: 0  fail: 0"


@pytest.mark.parametrize("arch,kind", [("granite3_2b", "prefill"), ("mamba2_370m", "prefill"),
                                       ("granite_moe_3b_a800m", "train")])
def test_step_trace_flops_equal_flop_counter_mode(arch, kind):
    """The dry run's count is ``FlopCounterMode``'s (the card's check
    holds the latter on the card to the former's on meta)."""
    from repro_torch.models.config import ShapeConfig

    cfg = port_config_for(arch)
    shape = ShapeConfig("cut", 256, 2, kind)
    counts = []
    for mode in (FlopCounterMode(display=False), D.StepTrace()):
        step = D.make_step(cfg, shape, 2, "meta", torch.Generator("cpu"))
        with mode:
            step.run()
        counts.append(mode.get_total_flops() if isinstance(mode, FlopCounterMode)
                      else mode.flops)
    assert counts[0] == counts[1] > 0


def test_step_trace_counts_by_provenance_not_shape():
    """At granite's train_4k on 16x16 a microbatch is 2 x 4,096 = 8,192
    tokens, granite's d_ff: an activation of w_down's shape (8192, 2048)
    counts in full on one device, while w_down's bf16 cast, its gradient
    and its update count at the weight's shard."""
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import transformer as T

    cfg = port_config_for("granite3_2b")
    mesh = D.stand_in_mesh("16x16")
    params = T.init_params(torch.Generator("cpu"), cfg, "meta")
    specs = D._spec_leaves(param_specs(params, mesh, cfg))
    w, spec = next((t, s) for t, s in zip(D._tensors(params), specs, strict=True)
                   if t.shape == (cfg.d_ff, cfg.d_model))
    shards = D._shards(spec, mesh)
    assert w.shape == (8192, 2048) and shards == 256
    tracer = D.StepTrace()
    tracer.argument(w, w.nbytes / shards)
    master = w.detach().requires_grad_(True)
    h = torch.empty((8192, cfg.d_ff), dtype=torch.bfloat16, device="meta")
    with tracer:
        cast = master.to(torch.bfloat16)
        y = h @ cast  # the activation
        y.float().sum().backward()
        new_w = w - 1e-3 * master.grad
    assert y.shape == w.shape
    assert tracer.bytes_of_tensors([y]) == y.nbytes
    for t in (cast, master.grad, new_w):
        assert tracer.bytes_of_tensors([t]) == t.nbytes / shards
    assert tracer.peak >= y.nbytes


def test_one_card_memory_of_a_training_step():
    """On one card the arguments are the whole state; a training step holds
    the old and the new state, the gradients and the activations at once."""
    from repro_torch.models.config import ShapeConfig

    cfg = port_config_for("mamba2_370m")
    rec = D.dryrun_cell("mamba2_370m", ShapeConfig("train_cut", 512, 2, "train"),
                        mesh_name="1x1", microbatches=2)
    mem = rec["memory"]
    n = sum(t.numel() for t in tree_leaves(build_model(cfg, "meta").init_shapes()))
    state = 4 * n + 2 * 2 * n + 4  # float32 masters, bf16 m and v, the step
    assert mem["alias_bytes"] == state
    assert mem["argument_bytes"] == state + 2 * 2 * 512 * 4  # int32 tokens and labels
    assert mem["output_bytes"] >= state
    # the new state and the float32 gradients on top of the old state
    assert mem["per_device_total"] > 2 * state + 4 * n


def test_mamba_prefill_cache_holds_no_view_of_a_larger_tensor():
    """C14: the conv state handed to the decode cache is a copy, not a view
    of the layer's whole projection."""
    cfg = smoke_config_for("mamba2_370m")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    _, cache = model.prefill(torch.zeros((2, 40), dtype=torch.int32))
    for t in (t for t in tree_leaves(cache) if isinstance(t, torch.Tensor)):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_chip_smoke_launch_entries():
    """The entry points ``chip_smoke.py``'s dry-run phase wraps exist, one
    for each custom op, and its counts are ``launch/roofline.py``'s."""
    spec = importlib.util.spec_from_file_location("chip_smoke_dryrun", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for op, (kernel, attr) in smoke.LAUNCH_ENTRIES.items():
        assert hasattr(torch.ops.repro_torch, op)
        module = importlib.import_module(f"repro_torch.kernels.{kernel}.{kernel}")
        assert callable(getattr(module, attr))
    assert smoke.valid_pairs is PRL.valid_pairs and smoke.ssd_ops_needed is PRL.ssd_ops_needed
    assert smoke.ssd_bwd_ops_needed is PRL.ssd_bwd_ops_needed
    store = {}
    with smoke.launch_inputs(store):
        pass
    assert ssd_binding.plan.__name__ == "plan"
