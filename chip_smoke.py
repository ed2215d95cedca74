#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU and the CUDA toolkit (``nvcc``); imports nothing of
JAX and nothing of the reference package.  Every phase must pass, or the
script exits non-zero:

1. build — compiles the port's CUDA kernels (``csrc/relagg.cu``,
   ``csrc/flash_attention.cu``, ``csrc/ssd_scan.cu``, one ``nvcc`` each, in
   parallel) from the sources in this checkout, and prints each kernel
   instance's registers, shared memory and spills (``ptxas -v``) and its
   tensor-core instructions (HGMMA and TF32 HMMA, from ``cuobjdump
   -sass``); a bf16
   flash_attention instance without HGMMA fails (the forward at D = 16,
   64, 96, 128, 256; the backward's ``flash_bwd_dkdv_bf16`` and
   ``flash_bwd_dq_bf16`` at the same five), and so does a spill in
   the bf16 forward at D = 96 and 256 or in any backward kernel, an
   ssd_scan kernel that spills, a set of ssd_scan kernels other than its
   four forward and six backward passes, or a backward kernel of
   ``ssd_bwd_chunk_dx`` and ``ssd_bwd_chunk_dbc`` without TF32 HMMA;
2. kernels — each kernel against its plain torch version on the card:
   relagg on the shared-memory and the global-atomics path, with an empty
   mask and with out-of-range group ids, its sums also within 1 float32
   ulp of the float64 sum and, on the shared-memory path, bit-identical
   across launches; relagg with a batch axis (B = 1, 3, 16 and 70,000,
   inputs batched or shared with stride 0) against unbatched launches
   (bit-identical on the shared-memory path; above 256 items a sample
   with every chunk boundary) and its batched plain version; flash_attention causal and not,
   with windows (1,024 keys at D = 96 and 256), GQA and MHA, a decode
   offset, ragged lengths, rows with no valid key, bf16 (the tensor-core
   kernel) and float32 (the CUDA-core one), head dims 16/64/96/128/256;
   ssd_scan with one and 32 heads per group, L = 1, 40 (under one chunk),
   100, 1819, 2048, mamba2-370m's and jamba-1.5's widths (P = N = 128, 8
   groups), 70,000 heads, against the per-step recurrence and, with the
   states it passes between chunks, the plain version of its own four
   passes;
3. main path — TPC-H at scale factor 1 (6,000,000 ``lineitem`` rows) on the
   card through ``Session.prepare`` / ``PreparedStatement.execute``: Q1,
   Q3, Q5, Q6, Q12 and Q14 in UDF and original form under FROID with
   ``pallas_agg`` on and off, cold then warm;
4. cross-device — the same queries at ``sf=0.01`` on the CPU and on the
   card;
5. times — relagg on the inputs the main path handed it for Q12 and Q5:
   checked against the plain version, then timed as the kernel, the plain
   version and one PyTorch call computing the same function, beside the
   bound that this data needs; the kernel's device time from a
   ``torch.profiler`` trace, its host cost and its device events per call
   apart from the CUDA-event figure; two more launches bit-identical and
   within 1 ulp of the float64 sum;
6. iterative UDFs — the paper's Fig. 9: the six TPC-H UDF queries under
   INTERPRETED (``lineitem`` cut to 300 rows) and HEKATON (3,000 rows),
   every other table at SF 1, with ``pallas_agg`` on: each held to FROID
   on the same cut session, relagg launching in Q5 and Q12 under both,
   the outputs on the card; per invocation, extrapolated to SF 1 and
   against FROID's warm time.  Then a loop-free HEKATON body over 3,000
   rows under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync),
   and the cursor loops: ``examples/cursor_loops.py``'s UDF under FROID
   (rewritten to a ``LoopScan``), INTERPRETED and HEKATON against the loop
   written out in numpy; both loop kinds under the three policies at 300
   ``facts`` rows, FROID's plans checked, with relagg launching in a
   grouped query over a loop UDF's output; FROID against HEKATON at 3,000
   rows (scan kind), FROID's plan also with no host sync; and the reduce
   kind at 6,000,000 rows (FROID).  Then correlated subqueries, each one
   ``torch.func.vmap`` over the outer rows: the decorrelation oracle's
   shapes (5 kinds x 4 key shapes, the five aggregates, a grouped body
   with relagg on and off) over 64 ``keys`` and 20,000 ``facts`` rows,
   FROID == the per-row plan == the CPU; and at SF 1, for 16 ``orders``
   rows over all of ``lineitem``, a SUM, the same grouped by
   ``l_shipmode`` (relagg launching batched; also with ``pallas_agg``
   off) and an EXISTS under a non-equi correlation, each against its
   float64 answer and once with no host sync, and relagg's batched call
   at the grouped statement's inputs timed.  Then the invocation phase
   (``execute_many``, ``execute_async``, the scheduler): (a)
   ``benchmarks/bench_execute_many.py``'s ``key_total`` over a
   6,000,000-row ``detail`` and 2,000-row ``T`` (relagg on), at N = 1,
   32 and 1,024 the serial ``execute`` loop, ``execute_many`` and N
   ``execute_async`` calls, each ticket against float64 and the serial
   loop, relagg launching once an ``execute_many`` call (the decorrelated
   build is unbatched) and once a ticket serially; N = 33 (bucket 64)
   against N = 32; one chunk's and one async dispatch with no host sync;
   (b) SF 1 ``lineitem`` filtered by ``l_shipdate <= param("d")`` and
   grouped by ``l_shipmode``, ``execute_many`` over the 16 dates, relagg
   on (one batched launch a call) and off, against float64 and the serial
   loop; (c) admission's ``evaluate_coalesced`` against ``evaluate`` and
   the rules under FROID, INTERPRETED and HEKATON.  Then the fused phase
   (``Session.execute_fused``, ``CoalescingScheduler(fuse=True)``): (a)
   ``benchmarks/bench_fused.py``'s mixed queue of six statements, 64
   tickets each, over the invocation phase's tables (relagg on), drained
   per statement and fused: every ticket == float64, the first 48 == the
   serial loop, relagg's shared build over ``detail`` launched once a
   fused wave against once a ``key_total`` statement, one fused wave's
   dispatch with no host sync; (b) its overlap queue (one template over an
   8-value cutoff pool), both drains; (c) the fusion oracle's queue over
   20,000 ``facts`` rows under FROID and HEKATON, fused == serial == the
   CPU; (d) admission's ``evaluate_coalesced`` with ``fuse=True`` against
   ``evaluate``.  Then the routed phase (``ROUTED``, the cost router):
   (a) ``benchmarks/bench_cost_routing.py``'s queue (3 statements x 48
   tickets) and (b) the fused phase's overlap queue, each drained 6 times
   under ``ROUTED`` (explore fused, explore per statement, then the
   measured winner, checked against the router's own EMAs) in turns with
   the static FROID arms, every ticket == the serial loop == float64; (c)
   routed against static ``execute_many`` of ``key_total`` (k = 128,
   cache-resident); (d) the bucket axis at N = 100 with bucket 1,024
   warm; (e) on the SF-1 session, Q6 and Q12 in UDF form under
   ``ROUTED``: the router's verdict, and a FROID verdict's rows == FROID
   unrouted; (f) the routing oracle at 20,000 ``facts`` rows, fused and
   not, card == CPU == FROID serial; one routed dispatch with no host
   sync.  Then the fleet phase (``Session(store=...)``, ``FleetEngine``):
   (a) the six TPC-H UDF queries at SF 1 (relagg on) in a session over an
   empty store, then in a second session over the same data, each first
   call a store hit with the first session's rows bit for bit and its
   explain; (b) one entry cut in half: a ``PlanCacheWarning``, a rebuild,
   the same rows; (c) ``benchmarks/bench_fleet.py``'s 12 statements over
   6,000,000 ``T`` rows, first calls cold and warm, its 96-request trace
   drained by one session and by one- and two-worker fleets, every ticket
   == the serial oracle, and relagg launched from two host threads at
   once; (d) a two-worker ``ROUTED`` fleet over the routing queue drained
   until it has measured, its costs saved, and a fresh fleet that loads
   them and explores nothing; (e) ``AdmissionPolicy(store=...)`` cold and
   warm.  Then the mesh phase (``policy.sharded(mesh)``, meshes naming
   ``cuda:0`` 2 and 4 times): (a) ``key_total`` over the invocation
   tables at N = 32 and 1,024 through ``execute_many`` unsharded and
   sharded, in turns, every ticket == float64 and the serial loop, relagg
   once a shard a call, the sharded sums against the unsharded bit for
   bit, the shard cache's hits; (b) the fusion oracle's session drained as
   one sharded wave with mixed divisibility (8 + 3 and 8 + 2 tickets and a
   parameter-free member; buckets 8, 4, 1), every ticket == serial; (c)
   ``AdmissionPolicy(mesh=...)`` == tick == the rules, and a scheduler
   flushing at ``max_batch × 4``; (d) a second session over a store hits
   the first's ``"shard"`` entry, rows bit for bit; (e) ``ROUTED`` sharded
   ``execute_many`` == FROID serial, the router keyed by the shard token;
   (f) where there are several cards, (a)-(e) again over all of them;
7. serving — granite-3-2b, mamba2-370m, phi3-mini-3.8b (head dim 96),
   gemma3-12b (head dim 256, 1,024-token windows on 40 of its 48
   layers), granite-moe-3b-a800m and minicpm3-4b (multi-head latent
   attention: flash at qk 64 + 32 = 96 with v's 64 zero-padded to 96, and
   decode against the compressed latent cache) at their published widths
   and depths, one after the other,
   through ``ServeEngine.run`` with Froid-compiled admission on the card:
   8 requests with 512-2048-token prompts plus one 33,000-token prompt
   that the ``admit`` rule rejects, served twice (granite, mamba) or once
   (the others), with the kernel launches counted over the first run,
   the peak device memory, granite also through ``submit``/``drain``
   (equal to ``run``'s completions), and a traced prefill's port kernels
   checked by name and count (the bf16 flash kernel at the model's head dim, the four
   ssd_scan passes once a layer each);
8. LM kernel times — flash_attention and ssd_scan on the inputs the
   serving path handed them (gemma3: a global and a local layer), against
   the plain version, the library call (``scaled_dot_product_attention``,
   with the window as a mask where there is one; none computes the SSD
   scan) and the bound that this data needs, ssd_scan also split by pass
   and beside its scratch bytes; flash_attention in bf16 also against the
   plain version in float32 by mean |diff|, beside a control that leaves
   one 64-key tile out and must read above the limit (over the rows that
   tile reaches, and at granite's layer over all rows as well);
9. LM cross-device — the smoke configs' prefill and decode logits (phi3's
   and gemma3's at their published head dims, 96 and 256, and minicpm3's
   at its smoke MLA dims and again at the published ones, qk 64 + 32 and
   v 64, each of the last three beside the same with the plain version in
   place of the kernel on the card) and the admission verdicts on the CPU
   and on the card;
10. training (ROADMAP A16.1, A16.2) — (a) flash_attention's backward kernels
   (``flash_bwd_preprocess``, then dK/dV and dQ: on the tensor cores in
   bf16, ``flash_bwd_dkdv_bf16`` and ``flash_bwd_dq_bf16``; on the CUDA
   cores in float32, ``flash_bwd_dkdv`` and ``flash_bwd_dq``) against ``flash_attention_bwd_ref`` in float32 and bf16
   at head dims 16 to 256 (granite-3-2b's training layer, gemma3-12b's
   1,024-key window with a query offset at 1, 40 and 1,000 queries, rows
   with no valid key), the forward's log-sum-exp against the plain one's,
   dQ/dK/dV bit-equal across two launches, and the ``autograd.Function``
   under a checkpoint (D = 64,
   and 24 through the padding) against torch autograd of the float32
   plain version; (b) the data pipeline at 8 x 4,096 tokens, FROID ==
   INTERPRETED on the card == the CPU bit for bit; (c) granite-3-2b at
   full width, random weights from seed 0, 6 steps of ``train_loop`` over
   4 x 4,096 tokens in 2 microbatches with remat: losses finite, the loss
   of one batch the run does not train on lower after the 6 steps than
   before, 160 forward and 80 backward flash launches a step, ms a step,
   tokens/s, peak memory, one traced step, and the first step on 1,024
   tokens with the kernels against the plain attention; (d) the smoke
   config card against CPU over 8 steps (losses, and each parameter's
   move from its initial value, beside a control with the flash
   backward's dK zeroed that must fail), microbatches, compression,
   a checkpoint restored and continued bit for bit, the launcher resuming;
   (e) the backward's times at granite's training inputs, by kernel and
   in TFLOP/s, beside its bound, the plain backward and
   ``scaled_dot_product_attention``'s; the same at phi3-mini-3.8b's layer
   (D = 96, MHA) and gemma3-12b's global one (D = 256) from random
   inputs; (ROADMAP A16.2) (f) ssd_scan's backward kernels
   (``ssd_bwd_dstate``, ``ssd_bwd_state_pass``, ``ssd_bwd_chunk_dx``,
   ``ssd_bwd_chunk_dbc``, ``ssd_bwd_dbc_sum``, ``ssd_bwd_ddtA``) against
   ``ssd_scan_bwd_ref`` in float64 at the forward sweep's shapes,
   mamba2-370m's training inputs (also at strong decays), 3 and 12 heads
   a group and N = 256, with dy one position off as a control, bit-equal
   across two launches, and ``ops.SSDScan`` under a checkpoint; (g)
   mamba2-370m at full width and depth, random weights from seed 0, 6
   steps of 4 x 4,096 tokens in 2 microbatches with remat: losses finite,
   192 forward and 96 backward ssd launches a step, ms a step, tokens/s,
   peak memory, one traced step, the held-out batch's loss read (six steps
   do not move it past its noise: it is also read after the same steps
   with the float64 plain ssd backward), and the first step's gradients in
   float32 compute, every leaf within ``MAMBA_GRAD_TOL`` of those with the
   float64 plain ssd backward in the kernels' place, ddtA zeroed as a
   control;
   (h) the ssd backward's times at (g)'s captured inputs, by kernel,
   beside its bound (the reverse recurrence's work) and each kernel's own
   share of it, the plain backward and the forward; (i) mamba's smoke
   config card against CPU over 8 steps as (d), the control zeroing the
   ssd backward's ddtA.

It prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the port's sources beside it, it exits non-zero
and prints no result.

    python3 chip_smoke.py --flash-digest

runs only the flash_attention sweep's cases at head dims 16, 64 and 128
and prints a sha256 of each output: the same line from two source trees
on one card says their kernels computed the same bits.

    python3 chip_smoke.py --relagg-times

builds relagg alone and reads it at Q12's and Q5's inputs (TPC-H at SF 1)
as phase 5 does, its repeat readings not checked: copied into another
source tree, it reads that tree's kernel the same way.

    python3 chip_smoke.py --relagg-variants

builds the edits of ``csrc/relagg.cu`` in :data:`RELAGG_VARIANTS` (designs
the source chose against, and probes that leave part of the work out) and
reads each one's device time in turns with the shipped kernel at Q12's
and Q5's inputs.

    python3 chip_smoke.py --mesh

builds relagg alone and runs the mesh phase alone; on a machine with
several cards its (f) leg runs it again over a mesh of every card.

    python3 chip_smoke.py --train

builds flash_attention and ssd_scan alone and runs the training phase
(10) alone.

    python3 chip_smoke.py --ssd-bwd-times

builds ssd_scan alone and times its backward at mamba2-370m's
training-step inputs (BH 64, BG 2, L 4,096, P 64, N 128, from a seed),
after holding it to the float64 plain backward at |dtA| up to 0.5 and 50:
whole and by kernel, each kernel beside its own bound.  It reads the
kernels from the binding's ``BACKWARD_PASSES``: copied into another
source tree, it times that tree's kernels the same way.

    python3 chip_smoke.py --train-seeds

builds flash_attention and ssd_scan alone and runs (c)'s 6 granite steps
from the initial states of seeds 0, 1 and 2, printing each step's batch
loss, the held-out batch's loss before and after, and which of two gates
holds (the last step's batch loss below the first's; the held-out batch's
loss falling), then (d)'s and (i)'s card-against-CPU checks from the same
seeds: copied into another source tree, it runs that tree's kernels the
same way.

    python3 chip_smoke.py --flash-variants

builds the edits of ``csrc/flash_attention.cu`` in :data:`FLASH_VARIANTS`
(designs the source chose against) and times each in turns with the
shipped kernel at the serving path's prefill shapes, after checking it
against the plain version.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import gc
import hashlib
import importlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
#: H100 SXM data sheet: device-memory rate, float32 (non-tensor-core) peak
#: and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
KERNELS = ("relagg", "flash_attention", "ssd_scan")
QUERY_NAMES = ("Q1", "Q3", "Q5", "Q6", "Q12", "Q14")
WARM_ROUNDS = 4


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# build report
# ---------------------------------------------------------------------------


def demangle(names: list[str], tool: pathlib.Path) -> list[str]:
    """Kernel names as ``cu++filt`` gives them, without the anonymous
    namespace and the argument list; the mangled names if it is missing."""
    if not tool.exists():
        return names
    out = subprocess.run([str(tool)], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    short = [re.sub(r"\(anonymous namespace\)::", "", n) for n in out]
    return [re.sub(r"^void |\([^()]*\)$", "", n) for n in short]


def ptxas_report(text: str) -> dict[str, dict]:
    """Registers, static shared memory and spills per kernel, from the
    ``ptxas -v`` lines that the build kept."""
    found: dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            found[name] = {"registers": None, "smem": 0, "spill_stores": None,
                           "spill_loads": None}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found[name]["spill_stores"], found[name]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            found[name]["smem"] = int(sm.group(1)) if sm else 0
    return found


def tensor_core_counts(lib: pathlib.Path, tool: pathlib.Path) -> dict[str, dict[str, int]]:
    """Tensor-core instructions per kernel in the library's SASS: HGMMA
    (``wgmma``) and HMMA with TF32 operands (``mma.sync`` ... ``tf32``)."""
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"hgmma": 0, "hmma_tf32": 0}
        elif name is not None and "HGMMA" in line:
            counts[name]["hgmma"] += 1
        elif name is not None and "HMMA" in line and "TF32" in line:
            counts[name]["hmma_tf32"] += 1
    return counts


def flash_head_dim(name: str, kernel: str = "flash_fwd_bf16") -> int:
    """D of a bf16 flash_attention instance of ``kernel``, from its
    demangled name (``tc::flash_fwd_bf16<(int)96>``) or its mangled one
    (``flash_fwd_bf16ILi96E``)."""
    m = re.search(kernel + r"(?:<(?:\(int\))?|ILi)(\d+)", name)
    check(m is not None, f"no head dim in the kernel name {name}")
    return int(m.group(1))


#: the backward's dK/dV and dQ kernels on the tensor cores, bf16 at every
#: head dim (their CUDA-core counterparts take float32)
FLASH_BWD_TC = ("flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16")
#: ssd_scan's backward kernels whose products run on the tensor cores
#: (mma.sync, 3xTF32)
SSD_BWD_TC = ("ssd_bwd_chunk_dx", "ssd_bwd_chunk_dbc")


def build_report() -> dict[str, dict]:
    """Per kernel instance of the three libraries: ``ptxas -v``'s registers,
    shared memory and spills, and the HGMMA and TF32 HMMA counts of its
    SASS.  Fails unless each bf16 flash_attention instance (D = 16, 64, 96,
    128, 256) holds tensor-core instructions, or if those at D = 96 and 256
    spill, or if a flash_attention backward kernel (preprocess in two
    dtypes, dK/dV and dQ on the tensor cores in bf16, each holding HGMMA,
    and on the CUDA cores in float32, each at the five head dims) is
    missing or spills; or unless ssd_scan.cu holds its forward and backward
    kernels, none spilling, each of :data:`SSD_BWD_TC` with TF32 HMMA."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
    from repro_torch.kernels.ssd_scan.ssd_scan import BACKWARD_PASSES, PASSES

    bindir = pathlib.Path(_build._nvcc()).parent
    report = {}
    for kernel in KERNELS:
        text = _build.build_log(kernel)
        for line in text.splitlines():
            if "warning" in line.lower() or "wgmma" in line.lower():
                log(f"ptxas {kernel}.cu: {line.strip()}")
        res = ptxas_report(text)
        cores = tensor_core_counts(_build.library_path(kernel), bindir / "cuobjdump")
        mangled = sorted(res)
        for m, name in zip(mangled, demangle(mangled, bindir / "cu++filt")):
            r = report[name] = {**res[m], **cores.get(m, {"hgmma": 0, "hmma_tf32": 0}),
                                "source": f"{kernel}.cu"}
            log(f"ptxas {name} ({kernel}.cu): {r['registers']} registers, {r['smem']} bytes "
                f"static shared memory, spill stores {r['spill_stores']} / loads "
                f"{r['spill_loads']} bytes; HGMMA / TF32 HMMA instructions in its SASS: "
                f"{r['hgmma']} / {r['hmma_tf32']}")
    bf16 = {flash_head_dim(n): r for n, r in report.items() if "flash_fwd_bf16" in n}
    check(sorted(bf16) == list(HEAD_DIMS), f"expected the bf16 flash_attention instances "
          f"D = {HEAD_DIMS}: {sorted(bf16)}")
    check(all(r["hgmma"] for r in bf16.values()),
          f"a bf16 flash_attention instance has no HGMMA: {bf16}")
    check(all(bf16[D]["spill_stores"] == 0 and bf16[D]["spill_loads"] == 0 for D in (96, 256)),
          f"a bf16 flash_attention instance at D = 96 or 256 spills: {bf16}")
    bwd = {n: r for n, r in report.items() if "flash_bwd_" in n}
    check(len(bwd) == 3 * 2 * len(HEAD_DIMS), f"expected flash_bwd_preprocess, _dkdv and "
          f"_dq in float32 and bf16 at D = {HEAD_DIMS}: {sorted(bwd)}")
    for kernel in FLASH_BWD_TC:
        tc = {flash_head_dim(n, kernel): r for n, r in bwd.items() if kernel in n}
        check(sorted(tc) == list(HEAD_DIMS) and all(r["hgmma"] for r in tc.values()),
              f"expected {kernel} at D = {HEAD_DIMS}, each with HGMMA: {tc}")
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in bwd.values()),
          f"a flash_attention backward kernel spills: {bwd}")
    ssd = {n.split("::")[-1]: r for n, r in report.items() if r["source"] == "ssd_scan.cu"}
    check(set(ssd) == set(PASSES + BACKWARD_PASSES), f"ssd_scan.cu's kernels {sorted(ssd)}, "
          f"expected {list(PASSES + BACKWARD_PASSES)}")
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in ssd.values()),
          f"an ssd_scan kernel spills: {ssd}")
    check(all(ssd[k]["hmma_tf32"] > 0 for k in SSD_BWD_TC),
          f"an ssd_scan backward kernel of {SSD_BWD_TC} has no TF32 HMMA: {ssd}")
    # two blocks of 256 threads an SM for each tensor-core kernel: registers
    # within half the SM's 65,536, shared memory (dynamic, static and the
    # 1 KB a block the runtime keeps) within half its 233,472 bytes
    lib = _build.load("ssd_scan")
    for k, smem in (("ssd_bwd_chunk_dx", lib.ssd_bwd_dx_smem()),
                    ("ssd_bwd_chunk_dbc", lib.ssd_bwd_dbc_smem())):
        r = ssd[k]
        fits = r["registers"] * 256 * 2 <= 65536 and 2 * (smem + r["smem"] + 1024) <= 233472
        log(f"{k}: {smem} bytes of dynamic shared memory, {r['registers']} registers: "
            f"{'two blocks an SM' if fits else 'fewer than two blocks an SM'}")
        check(fits, f"{k} no longer runs two blocks an SM: {r}, {smem} bytes dynamic")
    return report


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def relagg_inputs(n: int, groups: int, k: int, seed: int, *, density=0.6,
                  out_of_range=0.05, mask_out_of_range=True):
    """Random relagg inputs on the card: a share of the rows carries a group
    id outside [0, G) (masked off unless ``mask_out_of_range`` is False)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    gid = torch.randint(0, groups, (n,), generator=g, device="cuda", dtype=torch.int32)
    mask = torch.rand(n, generator=g, device="cuda") < density
    oor = torch.rand(n, generator=g, device="cuda") < out_of_range
    low = torch.rand(n, generator=g, device="cuda") < 0.5
    bad = torch.where(low, -1 - (gid % 3), groups + (gid % 3))
    gid = torch.where(oor, bad, gid)
    if mask_out_of_range:
        mask = mask & ~oor
    vals = torch.randn((n, k), generator=g, device="cuda")
    return gid, mask, vals


def f64_reference(gid, mask, vals, groups: int):
    """(sums, sum of |v|, counts) per group in float64 on the host, from
    tensors or host arrays."""
    g, m, v = (x.cpu().numpy() if hasattr(x, "cpu") else x for x in (gid, mask, vals))
    sel = m & (g >= 0) & (g < groups)
    v = v.astype(np.float64)[sel]
    gs = g[sel]
    counts = np.bincount(gs, minlength=groups)
    sums = np.stack([np.bincount(gs, weights=v[:, j], minlength=groups)
                     for j in range(v.shape[1])], 1)
    absum = np.stack([np.bincount(gs, weights=np.abs(v[:, j]), minlength=groups)
                      for j in range(v.shape[1])], 1)
    return sums, absum, counts


def kernel_phase() -> dict:
    """relagg kernel vs plain on the card.  Counts must match exactly (and
    the float64 count); sums within 1e-4 * sum|v| per group of the float64
    sum and of the plain version — float32 rounding grows with the
    magnitudes summed, not with the result.  On top: within 1 float32 ulp
    of the float64 sum rounded once, and on the shared-memory path two more
    launches bit-identical (:func:`relagg_repeat`)."""
    from repro_torch.kernels.relagg import ops
    from repro_torch.kernels.relagg.ref import grouped_aggregate_ref
    from repro_torch.kernels.relagg.relagg import relagg_cuda, uses_shared

    cases = [(n, G, k, {}) for n in (64, 257, 4096, 6_000_000)
             for G in (1, 7, 25, 130, 150_000) for k in (1, 4, 8)]
    cases += [
        (4096, 7, 4, {"density": 0.0}),
        (6_000_000, 25, 2, {"density": 0.0}),
        # the main path's shapes and selectivities: Q5 keeps ~0.12% of its
        # rows, Q12 ~1%
        (6_000_000, 25, 2, {"density": 0.0012}),
        (6_000_000, 7, 4, {"density": 0.01}),
        (100_000, 130, 4, {"mask_out_of_range": False, "out_of_range": 0.3}),
        (100_000, 150_000, 2, {"mask_out_of_range": False, "out_of_range": 0.3}),
    ]
    max_err = 0.0
    paths = set()
    for i, (n, G, k, kw) in enumerate(cases):
        gid, mask, vals = relagg_inputs(n, G, k, seed=i, **kw)
        sums, counts = ops.grouped_aggregate(gid, mask, vals, G)
        psums, pcounts = grouped_aggregate_ref(gid, mask, vals, G)
        ref_sums, absum, ref_counts = f64_reference(gid, mask, vals, G)
        ks, kc = sums.cpu().numpy(), counts.cpu().numpy()
        ps, pc = psums.cpu().numpy(), pcounts.cpu().numpy()
        path = "shared" if uses_shared(G, k) else "global"
        paths.add(path)
        label = f"relagg n={n} G={G} k={k} {kw or ''} [{path}]"
        check(np.array_equal(kc, pc), f"{label}: counts differ from the plain version")
        check(np.array_equal(kc, ref_counts.astype(np.float32)),
              f"{label}: counts differ from the float64 count")
        tol = 1e-4 * absum
        err_truth = np.abs(ks.astype(np.float64) - ref_sums)
        err_plain = np.abs(ks.astype(np.float64) - ps.astype(np.float64))
        check((err_truth <= tol).all(), f"{label}: sums off the float64 sum, "
              f"worst {float((err_truth - tol).max())} over the bound")
        check((err_plain <= tol).all(), f"{label}: sums off the plain version, "
              f"worst {float((err_plain - tol).max())} over the bound")
        check((np.abs(ps.astype(np.float64) - ref_sums) <= tol).all(),
              f"{label}: the plain version is off the float64 sum")
        if kw.get("density") == 0.0:
            check(not ks.any() and not kc.any(), f"{label}: empty mask added something")
        repeat = relagg_repeat(label, lambda: relagg_cuda(gid, mask, vals, G), ref_sums,
                               path == "shared", strict=True)
        max_err = max(max_err, float(err_plain.max(initial=0.0)))
        log(f"{label}: ok (max |kernel - plain| {float(err_plain.max(initial=0.0)):.3g}, "
            f"{repeat['max_ulps']} ulps off the float64 sum, repeat bit-identical "
            f"{repeat['bit_identical']})")
    check(paths == {"shared", "global"}, f"kernel paths covered: {sorted(paths)}")
    batched = relagg_batched_cases()
    return {"cases": len(cases) + batched["cases"],
            "max_abs_err": max(max_err, batched["max_abs_err"])}


def f64_batched_reference(gid, mask, vals, groups: int):
    """(sums, sums of |v|, counts) per item and group in float64, as
    tensors on the card: gid and mask (B, n), vals (B, n, k)."""
    import torch

    B, n, k = vals.shape
    sel = mask & (gid >= 0) & (gid < groups)
    base = torch.arange(B, device=vals.device).reshape(B, 1) * groups
    slot = torch.where(sel, gid.to(torch.int64) + base, B * groups).reshape(-1)
    v = torch.where(sel[..., None], vals.to(torch.float64), 0.0).reshape(B * n, k)

    def add(x):
        out = torch.zeros((B * groups + 1,) + x.shape[1:], dtype=torch.float64,
                          device=vals.device).index_add_(0, slot, x)
        return out[:-1].reshape((B, groups) + x.shape[1:])

    return add(v), add(v.abs()), add(sel.reshape(-1).to(torch.float64))


#: the batched cases: (n, G, k, B, whether gid and vals are batched or one
#: item's expanded with stride 0, as a correlated subquery's inner columns
#: are).  The unbatched phase's n and G (at 6,000,000 rows G = 7 and
#: 150,000 only: the float64 reference's atomics on a few groups take
#: seconds there); B = 70,000 crosses ``gridDim.y``'s 65,535 on both paths,
#: and G = 150,000 at B = 300 takes the global path's scratch over its
#: budget (three chunks)
RELAGG_BATCHED = (
    [(n, G, 4 if G < 150_000 else 1, B, B == 3)
     for n in (64, 257, 4096, 6_000_000) for G in (1, 7, 25, 130, 150_000)
     for B in (1, 3, 16) if n < 6_000_000 or G in (7, 150_000)]
    + [(64, G, k, 70_000, both) for G, k in ((7, 4), (1000, 1)) for both in (False, True)]
    + [(1000, 150_000, 1, 300, False)])


#: items of a batched case held to unbatched launches one by one; above
#: it, a sample (the host's ~0.03 ms a launch makes 70,000 take seconds)
UNBATCHED_ALL = 256


def relagg_batched_cases() -> dict:
    """relagg's batched kernel (``relagg_cuda_batched``) on the card, each
    case against unbatched launches on the same items' inputs (every item
    up to :data:`UNBATCHED_ALL`, a sample with every chunk boundary above:
    sums the same bits on the shared path, within 1e-4 x the group's sum
    of |v| on the global one; counts exact), and every item against the
    batched plain version (counts exact, sums within that bound) and the
    float64 sums (the same bound)."""
    import torch

    from repro_torch.kernels.relagg.ref import grouped_aggregate_batched_ref
    from repro_torch.kernels.relagg.relagg import (
        _device, _lib, batch_chunk, launch_plan, relagg_cuda, relagg_cuda_batched, uses_shared)

    max_err, paths, chunked = 0.0, set(), set()
    for i, (n, G, k, B, batched_inputs) in enumerate(RELAGG_BATCHED):
        t0 = time.perf_counter()
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        mask = torch.rand((B, n), generator=g, device="cuda") < 0.6
        if batched_inputs:
            gid = torch.randint(-1, G + 1, (B, n), generator=g, device="cuda",
                                dtype=torch.int32)
            vals = torch.randn((B, n, k), generator=g, device="cuda")
        else:
            gid = torch.randint(-1, G + 1, (n,), generator=g, device="cuda",
                                dtype=torch.int32).expand(B, n)
            vals = torch.randn((n, k), generator=g, device="cuda").expand(B, n, k)
        out = relagg_cuda_batched(gid, mask, vals, G)
        shared = uses_shared(G, k)
        path = "shared" if shared else "global"
        paths.add(path)
        dev = _device(_lib(), torch.cuda.current_device())
        chunk = batch_chunk(B, launch_plan(dev.sm_count, dev.smem_budget, n, G, k))
        if chunk < B:
            chunked.add(path)
        label = (f"relagg batched B={B} n={n} G={G} k={k} "
                 f"{'all batched' if batched_inputs else 'gid, vals stride 0'} [{path}, "
                 f"{-(-B // chunk)} launches]")
        # every item, or above :data:`UNBATCHED_ALL` items every 97th, the
        # last, and two on each side of every chunk boundary
        items = np.arange(B) if B <= UNBATCHED_ALL else np.unique(np.concatenate([
            np.arange(0, B, 97), [B - 1],
            *(np.arange(c - 2, c + 2) for c in range(chunk, B, chunk))]))
        one = [relagg_cuda(gid[b], mask[b], vals[b], G) for b in items.tolist()]
        us = torch.stack([s for s, _ in one])
        uc = torch.stack([c for _, c in one])
        del one
        # the checks run on the card: the outputs reach 70,000 x 2,000 slots
        at = torch.as_tensor(items, device="cuda")
        ks, kc = out[..., :k], out[..., k]
        ps, pc = grouped_aggregate_batched_ref(gid, mask, vals, G)
        ref_sums, absum, ref_counts = f64_batched_reference(gid, mask, vals, G)
        tol = 1e-4 * absum
        check(torch.equal(kc[at], uc),
              f"{label}: counts differ from {len(items)} unbatched launches")
        check(torch.equal(kc, pc), f"{label}: counts differ from the plain version")
        check(torch.equal(kc.double(), ref_counts), f"{label}: counts differ from the "
              "float64 count")
        if shared:
            check(torch.equal(ks[at].contiguous().view(torch.int32), us.view(torch.int32)),
                  f"{label}: sums not bit-identical to {len(items)} unbatched launches")
        else:
            check(bool(((ks[at].double() - us.double()).abs() <= tol[at]).all()),
                  f"{label}: sums off {len(items)} unbatched launches")
        err_plain = (ks.double() - ps.double()).abs()
        check(bool((err_plain <= tol).all()), f"{label}: sums off the plain version, worst "
              f"{float((err_plain - tol).max())} over the bound")
        check(bool(((ks.double() - ref_sums).abs() <= tol).all()),
              f"{label}: sums off the float64 sum")
        max_err = max(max_err, float(err_plain.max()))
        log(f"{label}: ok (max |kernel - plain| {float(err_plain.max()):.3g}; "
            f"{len(items)} items against unbatched launches"
            f"{', bit-identical' if shared else ''}) in {time.perf_counter() - t0:.2f} s")
    empty = relagg_cuda_batched(torch.zeros((0, 5), dtype=torch.int32, device="cuda"),
                                torch.zeros((0, 5), dtype=torch.bool, device="cuda"),
                                torch.zeros((0, 5, 2), device="cuda"), 7)
    check(tuple(empty.shape) == (0, 7, 3), f"B = 0: output {tuple(empty.shape)}")
    check(paths == {"shared", "global"} and chunked == {"shared", "global"},
          f"batched relagg: paths {sorted(paths)}, chunked {sorted(chunked)}")
    return {"cases": len(RELAGG_BATCHED) + 1, "max_abs_err": max_err}


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def compare_tables(a, b, label: str, rtol: float, atol: float) -> None:
    """Rows equal in order: validity and non-float columns exactly, floats
    to ``rtol``/``atol``."""
    check(a.names() == b.names(), f"{label}: columns {a.names()} vs {b.names()}")
    check(a.num_rows == b.num_rows, f"{label}: {a.num_rows} vs {b.num_rows} rows")
    for name in a.names():
        ca, cb = a.columns[name], b.columns[name]
        va, vb = ca.validity().cpu().numpy(), cb.validity().cpu().numpy()
        check(np.array_equal(va, vb), f"{label}: validity of {name}")
        xa, xb = ca.data.cpu().numpy(), cb.data.cpu().numpy()
        check(xa.dtype == xb.dtype, f"{label}: dtype of {name}")
        if xa.dtype.kind == "f":
            ok = np.allclose(xa[va], xb[vb], rtol=rtol, atol=atol)
        else:
            ok = np.array_equal(xa[va], xb[vb])
        check(ok, f"{label}: values of {name}")


def run_statement(session, query, policy, rounds: int = WARM_ROUNDS):
    """Prepare, execute cold, then warm ``rounds`` times."""
    stmt = session.prepare(query, policy)
    cold = stmt.execute()
    check(not cold.cache_hit, "cold call reported a cache hit")
    warm = []
    for _ in range(rounds):
        r = stmt.execute()
        check(r.cache_hit, "warm call missed the cache")
        warm.append(r.elapsed_s * 1e3)
    return cold, float(np.median(warm))


def tpch_session(sf: float):
    """A session on the card holding TPC-H at scale factor ``sf`` and the
    UDFs of its queries."""
    import torch

    import repro_torch.core as C
    from repro_torch.data.tpch import generate_tpch
    from repro_torch.data.tpch_udfs import register_udfs

    session = C.Session()  # the card
    t0 = time.perf_counter()
    generate_tpch(session, sf=sf)
    register_udfs(session)
    torch.cuda.synchronize()
    resident = sum(t.nbytes() for t in session.catalog.values())
    log(f"TPC-H sf={sf}: {session.catalog['lineitem'].num_rows} lineitem rows, "
        f"{resident / 1e9:.3f} GB of columns on {session.device}, "
        f"generated and loaded in {time.perf_counter() - t0:.1f} s")
    return session


def main_path_phase(sf: float = 1.0) -> tuple[dict, object]:
    import torch

    import repro_torch.core as C
    from repro_torch.data.tpch_udfs import QUERIES
    from repro_torch.kernels.relagg import ops

    session = tpch_session(sf)
    on = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    off = C.FROID
    launches: dict[str, int] = {}
    summary = {}
    ops.LAUNCHES = 0  # counts from here to the end of the main path only
    for name in QUERY_NAMES:
        tables = {}
        before = ops.LAUNCHES
        for form, build in zip(("udf", "orig"), QUERIES[name]):
            for label, policy in (("on", on), ("off", off)):
                cold, warm_ms = run_statement(session, build(), policy)
                tables[form, label] = cold.table
                summary[f"{name}/{form}/relagg_{label}_warm_ms"] = warm_ms
                summary[f"{name}/{form}/relagg_{label}_cold_ms"] = cold.elapsed_s * 1e3
        launches[name] = ops.LAUNCHES - before
        for form in ("udf", "orig"):
            compare_tables(tables[form, "off"], tables[form, "on"],
                           f"{name}/{form} relagg on vs off", rtol=1e-4, atol=0.0)
        # UDF form vs original: the tolerance of examples/tpch_udf_demo.py
        compare_tables(tables["orig", "on"], tables["udf", "on"],
                       f"{name} udf vs orig", rtol=2e-3, atol=1e-2)
        first = tables["udf", "on"]
        check(first.num_rows > 0, f"{name}: no rows")
        for cname in first.names():
            d = first.columns[cname].data
            if d.is_floating_point():
                check(bool(torch.isfinite(d).all()), f"{name}: non-finite {cname}")
        log(f"{name}: ok, {first.num_rows} rows, relagg launches {launches[name]}; warm ms "
            + ", ".join(f"{form} relagg {lab} "
                        f"{summary[f'{name}/{form}/relagg_{lab}_warm_ms']:.2f}"
                        for form in ("udf", "orig") for lab in ("on", "off")))
    total = ops.LAUNCHES
    for name in ("Q5", "Q12"):
        check(launches[name] > 0, f"{name} did not launch the relagg kernel")
    log(f"relagg launches on the main path: {total} ({launches})")
    return {"launches": total, "per_query": launches, "times": summary}, session


def cross_device_phase(sf: float = 0.01) -> None:
    import repro_torch.core as C
    from repro_torch.data.tpch import generate_tpch
    from repro_torch.data.tpch_udfs import QUERIES, register_udfs

    policy = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    sessions = {}
    for device in ("cpu", None):
        s = C.Session(device=device)
        generate_tpch(s, sf=sf)
        register_udfs(s)
        sessions[device] = s
    for name in QUERY_NAMES:
        for form, build in zip(("udf", "orig"), QUERIES[name]):
            a = sessions["cpu"].execute(build(), policy).table
            b = sessions[None].execute(build(), policy).table
            compare_tables(a, b, f"{name}/{form} cpu vs card", rtol=1e-4, atol=1e-6)
    log(f"cross-device: sf={sf} cpu == card for {len(QUERY_NAMES) * 2} statements")


def capture_relagg_args(session, name: str):
    """The inputs the main path hands relagg for query ``name`` (UDF form)."""
    import repro_torch.core as C
    from repro_torch.data.tpch_udfs import QUERIES
    from repro_torch.kernels.relagg import ops

    captured = []
    launch = ops.grouped_aggregate

    def recording(gid, mask, vals, num_groups):
        captured.append((gid, mask, vals, num_groups))
        return launch(gid, mask, vals, num_groups)

    ops.grouped_aggregate = recording
    try:
        session.execute(QUERIES[name][0](),
                        C.ExecutionPolicy(name="froid+relagg", pallas_agg=True))
    finally:
        ops.grouped_aggregate = launch
    check(len(captured) == 1, f"{name}: expected one relagg call, got {len(captured)}")
    return captured[0]


def sectors_touched(rows, row_bytes: int) -> int:
    """Distinct 32-byte sectors of a row-major array that ``rows`` touch."""
    import torch

    start = rows.to(torch.int64) * row_bytes
    steps = [min(j * 32, row_bytes - 1) for j in range((row_bytes + 31) // 32 + 1)]
    return int(torch.cat([(start + s) // 32 for s in steps]).unique().numel())


def f32_ulps(a, b) -> np.ndarray:
    """Distance in float32 units in the last place between ``a`` and ``b``
    (float32 arrays): the count of float32 values between them, +0 and -0
    as one."""
    def ordered(x):
        i = np.ascontiguousarray(x, dtype=np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def relagg_repeat(label: str, launch, ref_sums, deterministic: bool, strict: bool) -> dict:
    """Two more launches on the same inputs: whether their sums and counts
    are bit-identical to each other, and the sums' largest distance in
    float32 ulps from the float64 sum rounded once.  With ``strict`` these
    are checks: within 1 ulp, and on the ``deterministic`` path (the
    shared-memory one) bit-identical."""
    s1, c1 = launch()
    s2, c2 = launch()
    same = bool(np.array_equal(s1.cpu().numpy().view(np.uint32), s2.cpu().numpy().view(np.uint32))
                and np.array_equal(c1.cpu().numpy(), c2.cpu().numpy()))
    ulps = int(f32_ulps(s1.cpu().numpy(), ref_sums.astype(np.float32)).max(initial=0))
    if strict:
        check(same or not deterministic, f"{label}: two launches on the same inputs differ")
        check(ulps <= 1, f"{label}: sums {ulps} float32 ulps off the float64 sum rounded once")
    return {"bit_identical": same, "max_ulps": ulps}


def relagg_split(fn, calls: int = 20) -> dict:
    """The kernel's device time apart from its host cost: ``device_ms`` is
    the device time of the ``relagg*`` kernel events per call in a
    ``torch.profiler`` trace of ``calls`` back-to-back calls (one event a
    call on the shared path, so also their mean duration),
    ``launches_per_call`` the trace's device events (kernels, fills,
    copies) per call, and ``host_ms_per_call`` the host's time to issue one
    call (:func:`host_ms_per_call`)."""
    for _ in range(3):  # warm
        fn()

    def run():
        for _ in range(calls):
            fn()

    # a trace now and then loses device events, all of them at times, and
    # never adds one: read the more complete of two that hold any (of six
    # traces at most)
    traces = []
    for _ in range(6):
        trace = device_busy(run)
        traces += [trace] if trace[3] else []
        if len(traces) == 2:
            break
    check(traces, "relagg: six traces in a row hold no device event")
    _, _, port, events = max(traces, key=lambda r: r[3])
    relagg_ms = sum(e["ms"] for name, e in port.items()
                    if name.startswith("relagg") and "<" not in name)
    return {"device_ms": relagg_ms / calls, "launches_per_call": events / calls,
            "host_ms_per_call": host_ms_per_call(fn)}


def time_relagg(label: str, args, strict: bool = True) -> dict:
    """Check the kernel against the plain version on the main path's own
    inputs, then time both and the library call.  The bound counts the
    bytes this data needs: every mask byte, gid where the mask is set, vals
    of selected rows, and the (G, k+1) output.  Beside the event figure
    ``ms``, the kernel's device time, host cost and launches per call
    (:func:`relagg_split`), and, from two more launches, whether they are
    bit-identical and how many float32 ulps their sums lie from the float64
    sum rounded once (:func:`relagg_repeat`; checks unless ``strict`` is
    False, which only reads them)."""
    import torch

    from repro_torch.kernels.relagg.ref import grouped_aggregate_ref
    from repro_torch.kernels.relagg.relagg import relagg_cuda, uses_shared

    gid, mask, vals, G = args
    gid, mask, vals = gid.contiguous(), mask.contiguous(), vals.contiguous()
    n, k = vals.shape
    sel = mask & (gid >= 0) & (gid < G)

    ksums, kcounts = relagg_cuda(gid, mask, vals, G)
    psums, pcounts = grouped_aggregate_ref(gid, mask, vals, G)
    ref_sums, absum, ref_counts = f64_reference(gid, mask, vals, G)
    kc, kcs = kcounts.cpu().numpy(), ksums.cpu().numpy().astype(np.float64)
    check(np.array_equal(kc, pcounts.cpu().numpy()),
          f"relagg at {label}'s inputs: counts differ from the plain version")
    check(np.array_equal(kc, ref_counts.astype(np.float32)),
          f"relagg at {label}'s inputs: counts differ from the float64 count")
    err = np.abs(kcs - psums.cpu().numpy().astype(np.float64))
    check((err <= 1e-4 * absum).all(),
          f"relagg at {label}'s inputs: sums off the plain version by "
          f"{float((err - 1e-4 * absum).max())} over the bound")
    idx = torch.where(sel, gid, 0).to(torch.int64)
    src = torch.cat([torch.where(sel[:, None], vals, 0.0), sel[:, None].float()], 1)

    def library():
        return torch.zeros((G, k + 1), device=vals.device).index_add_(0, idx, src)

    def kernel():
        return relagg_cuda(gid, mask, vals, G)

    def plain():
        return grouped_aggregate_ref(gid, mask, vals, G)

    path = "shared" if uses_shared(G, k) else "global"
    repeat = relagg_repeat(f"relagg at {label}'s inputs", kernel, ref_sums,
                           path == "shared", strict)
    # turns: plain, kernel, kernel, plain; then the library call
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
    lib_ms = cuda_ms(library)
    split = relagg_split(kernel)
    masked_in = int(mask.sum())
    selected = int(sel.sum())
    out_bytes = G * (k + 1) * 4
    nbytes = n + masked_in * 4 + selected * 4 * k + out_bytes
    # the same reads at the device's 32-byte sector granularity
    sector_bytes = 32 * ((n + 31) // 32
                         + sectors_touched(torch.nonzero(mask).reshape(-1), 4)
                         + sectors_touched(torch.nonzero(sel).reshape(-1), 4 * k)) \
        + out_bytes
    ops_count = selected * (k + 1)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_count / F32_OPS_PER_S * 1e3
    return {
        "n": n, "groups": G, "k": k, "mask_set": masked_in, "selected": selected,
        "path": path,
        "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bytes": nbytes, "sector_bytes": sector_bytes,
        "sector_bound_ms": sector_bytes / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": float(err.max(initial=0.0)),
        "max_err_over_abs_sum": float(np.max(err / np.maximum(absum, 1e-30),
                                             initial=0.0)),
        **split, **repeat,
    }


def relagg_times_phase() -> dict:
    """``--relagg-times``: relagg alone at Q12's and Q5's inputs from TPC-H
    at SF 1, through :func:`time_relagg` with the repeat only read, so that
    this script, copied into another tree, reads that tree's kernel the
    same way."""
    from repro_torch.kernels import _build

    _build.load("relagg")
    session = tpch_session(1.0)
    return {label: time_relagg(label, capture_relagg_args(session, label), strict=False)
            for label in ("Q12", "Q5")}


def relagg_times_line(label: str, t: dict) -> str:
    return (f"relagg at {label}'s inputs, {t['path']} path: event {t['ms']:.5f} ms, device "
            f"{t['device_ms']:.5f} ms, host {t['host_ms_per_call']:.5f} ms and "
            f"{t['launches_per_call']:g} device events a call; bound {t['bound_ms']:.5f} ms; "
            f"bit-identical repeat {t['bit_identical']}, {t['max_ulps']} ulps off the "
            f"float64 sum")


#: ``lineitem`` rows of the cut sessions the iterative policies run on:
#: the reference's figure for INTERPRETED (``benchmarks/bench_tpch.py:50``)
#: and ten times it for HEKATON; every other table stays whole at SF 1
ITERATIVE_ROWS = {"interpreted": 300, "hekaton": 3000}
#: the tolerance of the UDF == original check (examples/tpch_udf_demo.py)
MODE_RTOL, MODE_ATOL = 2e-3, 1e-2


def cut_session(full, rows: int):
    """A session on the card holding ``full``'s tables with ``lineitem`` cut
    to its first ``rows`` rows (the reference's ``_subset_db``,
    ``benchmarks/bench_tpch.py:71``); the other tables are shared with
    ``full``, their statistics too."""
    import repro_torch.core as C
    from repro_torch.data.tpch_udfs import register_udfs
    from repro_torch.tables.table import Column, Table

    sub = C.Session()  # the card
    for name, t in full.catalog.items():
        if name == "lineitem":
            sub.create_table(name, Table({
                n: Column(c.data[:rows], None if c.valid is None else c.valid[:rows],
                          c.dictionary)
                for n, c in t.columns.items()}))
        else:
            sub.catalog[name] = t
    register_udfs(sub)
    return sub


def by_name(table):
    """``table`` with its columns in name order: two policies' plans may
    order them differently."""
    from repro_torch.tables.table import Table

    return Table({n: table.columns[n] for n in sorted(table.names())})


def as_float(table):
    """``table`` with every numeric column as float32: an interpreted UDF's
    column is float32 whatever the UDF returns (the reference's rule)."""
    import torch

    from repro_torch.tables.table import Column, Table

    return Table({n: Column(c.data.to(torch.float32)
                            if c.dictionary is None and c.data.dtype != torch.bool
                            else c.data, c.valid, c.dictionary)
                  for n, c in table.columns.items()})


def check_on_card(result, label: str) -> None:
    check(result.masked.mask.device.type == "cuda", f"{label}: mask is not on the card")
    for n, c in result.masked.table.columns.items():
        check(c.data.device.type == "cuda" and c.validity().device.type == "cuda",
              f"{label}: column {n} is not on the card")


def iterative_phase(full, froid_warm_ms: dict) -> dict:
    """The paper's Fig. 9 on the card: the six TPC-H UDF queries under
    INTERPRETED (the ``python``-mode interpreter) and HEKATON (``scan``
    mode, one row-function call per row), ``pallas_agg`` on, on sessions
    whose ``lineitem`` is cut (:data:`ITERATIVE_ROWS`).  The mode oracle
    holds on each cut session: FROID == INTERPRETED == HEKATON on the
    300-row one, FROID == HEKATON on the 3,000-row one (and INTERPRETED
    there too for a query that returned no rows at 300), at
    :data:`MODE_RTOL`/:data:`MODE_ATOL`; every query returns rows on one
    of them.  relagg must launch in Q5 and Q12
    under both iterative policies.  Each statement runs twice and the
    second (warm) run is the one timed: per invocation, extrapolated to
    ``full``'s ``lineitem`` rows, and against FROID's warm SF-1 time."""
    import dataclasses

    import repro_torch.core as C
    from repro_torch.data.tpch_udfs import QUERIES
    from repro_torch.kernels.relagg import ops

    froid = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    policies = {m: dataclasses.replace(C.PRESETS[m], name=m + "+relagg", pallas_agg=True)
                for m in ITERATIVE_ROWS}
    full_rows = full.catalog["lineitem"].num_rows
    runs, launched = {}, {}  # launched: the iterative statements' own
    result_rows: dict[str, int] = {}  # the most rows a query returned
    for session_mode, rows in ITERATIVE_ROWS.items():
        sub = cut_session(full, rows)
        for name in QUERY_NAMES:
            modes = list(ITERATIVE_ROWS)
            if session_mode == "hekaton" and result_rows[name] > 0:
                modes = ["hekaton"]  # INTERPRETED also where 300 rows gave none
            base = sub.execute(QUERIES[name][0](), froid)
            check_on_card(base, f"{name} froid at {rows} rows")
            result_rows[name] = max(result_rows.get(name, 0), base.table.num_rows)
            want = as_float(by_name(base.table))
            for mode in modes:
                label = f"{name} {mode} at {rows} rows"
                ops.LAUNCHES = 0  # counts this statement's two runs only
                stmt = sub.prepare(QUERIES[name][0](), policies[mode])
                cold = stmt.execute()
                warm = stmt.execute()
                launched[(mode, rows, name)] = ops.LAUNCHES
                for r in (cold, warm):
                    check_on_card(r, label)
                    compare_tables(want, as_float(by_name(r.table)),
                                   f"{label} vs froid", rtol=MODE_RTOL, atol=MODE_ATOL)
                if name in ("Q5", "Q12"):
                    check(launched[(mode, rows, name)] > 0,
                          f"{label}: relagg did not launch")
                st = warm.stats
                invocations = st["invocations"] if mode == "interpreted" else st["udf_rows"]
                ms = warm.elapsed_s * 1e3
                extrapolated_ms = ms * full_rows / rows
                rec = runs[(mode, rows, name)] = {
                    "mode": mode, "rows": rows, "query": name,
                    "result_rows": base.table.num_rows,
                    "cold_ms": cold.elapsed_s * 1e3, "warm_ms": ms,
                    "invocations": invocations,
                    "statements_executed": st.get("statements_executed"),
                    "udf_rows": st["udf_rows"],
                    "us_per_invocation": ms * 1e3 / max(invocations, 1),
                    "extrapolated_s": extrapolated_ms / 1e3,
                    "froid_sf1_warm_ms": froid_warm_ms[name],
                    "slowdown": extrapolated_ms / froid_warm_ms[name],
                    "relagg_launches": launched[(mode, rows, name)],
                }
                log(f"{label}: == froid ({base.table.num_rows} result rows); warm {ms:.1f} ms (cold {rec['cold_ms']:.1f}), "
                    f"{invocations} invocations"
                    + (f", {rec['statements_executed']} statements"
                       if mode == "interpreted" else " (one row-function call a row)")
                    + f", {rec['us_per_invocation']:.1f} us an invocation; at "
                    f"{full_rows} rows {rec['extrapolated_s']:.1f} s, "
                    f"{rec['slowdown']:.3g}x FROID's warm {froid_warm_ms[name]:.2f} ms; "
                    f"relagg launches {rec['relagg_launches']}")
        del sub
    for name in QUERY_NAMES:
        check(result_rows[name] > 0, f"{name} returned no rows on either cut session")
    return {"runs": list(runs.values()), "relagg_launches": sum(launched.values())}


def scan_mode_sync_check(full, rows: int = 3000) -> dict:
    """A loop-free UDF body in ``scan`` mode queues on the card without a
    host sync: the hook runs over ``rows`` ``lineitem`` rows under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    synchronising call (a blocking copy, a read of a device value)."""
    import torch

    import repro_torch.core as C
    from repro_torch.core import scalar as S

    sub = cut_session(full, rows)
    li = sub.catalog["lineitem"]
    env = {n: S.Value(c.data, c.valid, c.dictionary) for n, c in li.columns.items()}
    ctx = S.EvalContext(num_rows=li.num_rows, device=sub.device)
    calls = {"q6conditions": ("l_shipdate", "l_discount", "l_quantity"),
             "q12conditions": ("l_shipmode", "l_commitdate", "l_receiptdate", "l_shipdate"),
             "discount_taxprice": ("l_extendedprice", "l_discount", "l_tax")}
    out = {}
    for fname, args in calls.items():
        interp = C.Interpreter(sub.catalog, sub.registry, mode="scan")
        expr = S.UdfCall(fname, [S.ColRef(a) for a in args])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            v = interp.eval_udf_call(expr, env, ctx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        check(tuple(v.data.shape) == (rows,) and v.data.device == sub.device,
              f"{fname}: scan-mode output {tuple(v.data.shape)} on {v.data.device}")
        check(bool(torch.isfinite(v.data).all()), f"{fname}: non-finite scan-mode output")
        out[fname] = {"rows": rows, "host_ms": host_ms, "total_ms": total_ms,
                      "us_per_row": total_ms * 1e3 / rows}
        log(f"scan mode {fname} over {rows} rows: no host sync; issued in {host_ms:.1f} ms, "
            f"done in {total_ms:.1f} ms ({out[fname]['us_per_row']:.1f} us a row)")
    return out


def source_string(path: str, name: str) -> str:
    """A module-level string of the repo file ``path``, read from its source
    without running it."""
    import ast

    tree = ast.parse((ROOT / path).read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and node.targets[0].id == name
                and isinstance(node.value, ast.Constant)):
            return node.value.value
    raise RuntimeError(f"{path} has no string {name}")


#: ``facts`` rows of the cursor-loop cells: the mode oracle (FROID,
#: INTERPRETED and HEKATON, both loop kinds), the Aggify comparison (FROID
#: against HEKATON, scan kind) and the reduce kind at TPC-H SF 1's
#: ``lineitem`` row count (FROID only: interpreting it would take hours)
CURSOR_ROWS = {"oracle": 300, "aggify": 3000, "reduce": 6_000_000}


def cursor_facts(rows: int, seed: int = 0) -> tuple[np.ndarray, ...]:
    """``facts`` as ``examples/cursor_loops.py`` makes it (``fk``, ``val``),
    at ``rows`` rows, and after them the ``qty`` column that
    ``tests/test_loops.py``'s cursor also fetches."""
    rng = np.random.default_rng(seed)
    fk = rng.integers(0, 8, rows)
    val = np.round(rng.uniform(-10, 10, rows), 2).astype(np.float32)
    return fk, val, rng.integers(0, 9, rows)


def cursor_session(rows: int, keys: np.ndarray):
    """A session on the card with ``facts`` at ``rows`` rows, ``keys`` (and
    an int group key ``g``), and both loop UDFs: the example's
    ``cursor_total`` (scan kind) and ``tests/test_loops.py``'s commutative
    fold, registered as ``cursor_sum`` (reduce kind)."""
    import repro_torch.core as C

    s = C.Session()
    fk, val, qty = cursor_facts(rows)
    s.create_table("facts", fk=fk, val=val, qty=qty)
    s.create_table("keys", k=keys, g=keys % 2)
    s.create_function(C.parse_udf(source_string("examples/cursor_loops.py", "CURSOR_TOTAL")))
    s.create_function(C.parse_udf(source_string("tests/test_loops.py", "CURSOR_SUM")
                                  .replace("cursor_total", "cursor_sum")))
    return s, fk, val


def numpy_loop(fk, val, xs, kind: str) -> np.ndarray:
    """Each calling row's loop written out in numpy: ``cursor_total``'s
    ordered ``t = t * 0.5 + v`` with its BREAK, or ``cursor_sum``'s sum
    (in float64)."""
    out = []
    for x in xs:
        rows = val[fk <= x]
        if kind == "reduce":
            out.append(np.sum(rows, dtype=np.float64))
            continue
        t = np.float32(0.0)
        for v in rows:
            t = np.float32(t * np.float32(0.5) + v)
            if t > 75.0:
                break
        out.append(t)
    return np.asarray(out)


LOOP_UDF = {"scan": "cursor_total", "reduce": "cursor_sum"}


def loop_query(kind: str, scale: float = 1.0):
    import repro_torch.core as C

    return (C.scan("keys").compute(out=C.udf(LOOP_UDF[kind], C.col("k") * scale))
            .project("k", "out"))


def check_loop_plan(stmt, kind: str, label: str) -> None:
    """FROID's plan holds one ``LoopScan`` of ``kind`` and no UDF call."""
    from repro_torch.core import relalg as R
    from repro_torch.core import scalar as S

    plan = stmt.plan
    kinds = [n.kind for n in R.walk_plan_deep(plan) if isinstance(n, R.LoopScan)]
    calls = [e for n in R.walk_plan_deep(plan) for ex in n.exprs() for e in S.walk(ex)
             if isinstance(e, S.UdfCall)]
    text = stmt.explain()
    check(kinds == [kind] and not calls and f"LoopScan[{kind}]" in text,
          f"{label}: FROID's plan is not one LoopScan[{kind}] without a UDF call:\n{text}")
    log(f"{label}: FROID plan " + next(line.strip() for line in text.splitlines()
                                       if "LoopScan[" in line))


@contextlib.contextmanager
def loop_steps():
    """The rows each scan-kind ``LoopScan`` steps inside the block, call by
    call."""
    from repro_torch.core.executor import Executor

    orig, calls = Executor._loopscan_scan, []

    def recording(ex, node, child, init, ctx):
        calls.append(child.num_rows)
        return orig(ex, node, child, init, ctx)

    Executor._loopscan_scan = recording
    try:
        yield calls
    finally:
        Executor._loopscan_scan = orig


def check_loop_rows(result, expected, label: str, tol) -> None:
    check_on_card(result, label)
    got = result.table.columns["out"].data.cpu().numpy().astype(np.float64)
    check(got.shape == expected.shape and np.all(np.isfinite(got)),
          f"{label}: {got.shape} rows, finite {np.all(np.isfinite(got))}")
    err = np.abs(got - expected)
    excess = (err - tol).max()
    check(bool(excess <= 0), f"{label}: {got.tolist()} vs the loop's "
          f"{expected.tolist()} (max |diff| {err.max():.3g}, {excess:.3g} past its tolerance)")


def cursor_phase() -> dict:
    """Cursor-loop UDFs on the card.  (1) ``examples/cursor_loops.py``'s
    UDF over the example's 64 ``facts`` rows under FROID (rewritten to a
    ``LoopScan[scan]``), INTERPRETED and HEKATON, each held to the loop in
    numpy and to the others.  (2) The mode oracle at 300 ``facts`` rows,
    four calling rows, both loop kinds, FROID's plans checked; and a
    grouped query over the loop UDF's output with ``pallas_agg`` on, where
    relagg must launch and equal ``pallas_agg`` off and INTERPRETED.
    (3) The Aggify comparison at 3,000 rows, scan kind: FROID steps the
    cursor once for all calling rows, HEKATON once per calling row; FROID's
    plan also runs once under ``torch.cuda.set_sync_debug_mode("error")``.
    (4) The reduce kind over 6,000,000 rows and 16 calling rows, FROID
    only."""
    import dataclasses

    import torch

    import repro_torch.core as C
    from repro_torch.core.executor import Executor
    from repro_torch.kernels.relagg import ops

    out: dict = {}
    # (1) the example, as the example runs it
    s = C.Session()
    fk, val, _ = cursor_facts(64)
    s.create_table("facts", fk=fk, val=val)
    s.create_table("keys", k=np.arange(5))
    s.create_function(C.parse_udf(source_string("examples/cursor_loops.py", "CURSOR_TOTAL")))
    q = (C.scan("keys").filter(C.col("k") < C.param("cut"))
         .compute(out=C.udf("cursor_total", C.col("k") * 1.0)).project("k", "out"))
    cut = 4
    check_loop_plan(s.prepare(q, C.FROID), "scan", "example")
    expected = numpy_loop(fk, val, range(cut), "scan")
    tables, example = {}, {}
    for policy in (C.FROID, C.INTERPRETED, C.HEKATON):
        r = s.execute(q, policy, params={"cut": cut})
        check_loop_rows(r, expected, f"example {policy.name}", 1e-5 * (1 + np.abs(expected)))
        tables[policy.name] = r.table
        example[policy.name] = {"ms": r.elapsed_s * 1e3,
                                "out": r.table.columns["out"].data.cpu().tolist()}
    for name in ("interpreted", "hekaton"):
        compare_tables(tables["froid"], tables[name], f"example froid vs {name}",
                       rtol=MODE_RTOL, atol=MODE_ATOL)
    out["example"] = example
    log(f"cursor loop example: FROID (LoopScan) == INTERPRETED == HEKATON == the loop "
        f"in numpy, out {example['froid']['out']}; ms " + ", ".join(
            f"{k} {v['ms']:.1f}" for k, v in example.items()))

    # (2) the mode oracle at 300 rows, both kinds, and relagg over the output
    rows = CURSOR_ROWS["oracle"]
    keys = np.arange(4) * 2 + 1
    s, fk, val = cursor_session(rows, keys)
    oracle = {}
    for kind in ("scan", "reduce"):
        label = f"{kind} kind at {rows} rows"
        check_loop_plan(s.prepare(loop_query(kind), C.FROID), kind, label)
        expected = numpy_loop(fk, val, keys, kind)
        tables = {}
        for policy in (C.FROID, C.INTERPRETED, C.HEKATON):
            r = s.execute(loop_query(kind), policy)
            check_loop_rows(r, expected, f"{label} {policy.name}",
                            1e-4 * (1 + np.abs(expected)))
            tables[policy.name] = r.table
            oracle[f"{kind}/{policy.name}_ms"] = r.elapsed_s * 1e3
        for name in ("interpreted", "hekaton"):
            compare_tables(tables["froid"], tables[name], f"{label} froid vs {name}",
                           rtol=MODE_RTOL, atol=MODE_ATOL)
        log(f"{label}: FROID == INTERPRETED == HEKATON == the loop in numpy; ms "
            + ", ".join(f"{p} {oracle[f'{kind}/{p}_ms']:.1f}"
                        for p in ("froid", "interpreted", "hekaton")))
    grouped = (C.scan("keys").compute(out=C.udf("cursor_total", C.col("k") * 1.0))
               .group_by("g", capacity=2, s=C.sum_(C.col("out")), n=C.count_(C.col("out"))))
    relagg_on = dataclasses.replace(C.FROID, name="froid+relagg", pallas_agg=True)
    ops.LAUNCHES = 0  # counts this run of the slice's path only
    on = s.execute(grouped, relagg_on)
    launches = ops.LAUNCHES
    check(launches > 0, "grouped loop output: relagg did not launch")
    check_on_card(on, "grouped loop output")
    for policy in (C.FROID, C.INTERPRETED):
        compare_tables(on.table, s.execute(grouped, policy).table,
                       f"grouped loop output relagg vs {policy.name}",
                       rtol=MODE_RTOL, atol=MODE_ATOL)
    out["oracle"] = {**oracle, "rows": rows, "calling_rows": len(keys),
                     "relagg_launches": launches}
    log(f"grouped loop output at {rows} rows: relagg launched {launches} times, "
        f"== pallas_agg off == INTERPRETED")
    del s

    # (3) FROID against HEKATON at 3,000 rows, scan kind
    rows = CURSOR_ROWS["aggify"]
    s, fk, val = cursor_session(rows, keys)
    expected = numpy_loop(fk, val, keys, "scan")
    aggify: dict = {"rows": rows, "calling_rows": len(keys)}
    results = {}
    for policy in (C.FROID, C.HEKATON):
        stmt = s.prepare(loop_query("scan"), policy)
        if policy is C.FROID:
            check_loop_plan(stmt, "scan", f"scan kind at {rows} rows")
        cold = stmt.execute()
        with loop_steps() as steps:
            warm = stmt.execute()
        for r in (cold, warm):
            check_loop_rows(r, expected, f"scan kind at {rows} rows {policy.name}",
                            1e-4 * (1 + np.abs(expected)))
        results[policy.name] = warm.table
        stepped = (sum(steps) if policy is C.FROID
                   else warm.stats["udf_rows"] * rows)
        aggify[policy.name] = {"cold_ms": cold.elapsed_s * 1e3,
                               "warm_ms": warm.elapsed_s * 1e3,
                               "loopscan_calls": len(steps),
                               "rows_stepped": stepped}
    check(aggify["froid"]["loopscan_calls"] == 1
          and aggify["froid"]["rows_stepped"] == rows,
          f"FROID stepped {aggify['froid']['rows_stepped']} rows in "
          f"{aggify['froid']['loopscan_calls']} LoopScans, not {rows} in one")
    compare_tables(results["froid"], results["hekaton"], f"scan kind at {rows} rows",
                   rtol=MODE_RTOL, atol=MODE_ATOL)
    plan = s.prepare(loop_query("scan"), C.FROID).plan
    ex = Executor(s.catalog, device=s.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = ex.execute(plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    aggify["sync_check"] = {"host_ms": host_ms,
                            "total_ms": (time.perf_counter() - t0) * 1e3}
    got = res.table.columns["out"].data.cpu().numpy()
    check(np.allclose(got, expected, rtol=1e-4, atol=1e-4),
          f"scan kind under the sync check: {got.tolist()} vs {expected.tolist()}")
    f, h = aggify["froid"], aggify["hekaton"]
    log(f"scan kind at {rows} rows, {len(keys)} calling rows: FROID == HEKATON == the loop "
        f"in numpy; warm FROID {f['warm_ms']:.1f} ms ({f['rows_stepped']} rows stepped in "
        f"{f['loopscan_calls']} LoopScan), HEKATON {h['warm_ms']:.1f} ms ({h['rows_stepped']} "
        f"rows stepped), {h['warm_ms'] / f['warm_ms']:.2f}x; FROID's plan with no host sync: "
        f"issued in {host_ms:.1f} ms, done in {aggify['sync_check']['total_ms']:.1f} ms")
    out["aggify"] = aggify
    del s, ex, res

    # (4) the reduce kind at 6,000,000 rows, FROID only
    rows = CURSOR_ROWS["reduce"]
    keys = np.arange(16)
    s, fk, val = cursor_session(rows, keys)
    stmt = s.prepare(loop_query("reduce", 0.5), C.FROID)
    check_loop_plan(stmt, "reduce", f"reduce kind at {rows} rows")
    expected = numpy_loop(fk, val, keys * 0.5, "reduce")
    # a float32 sum of up to 6,000,000 terms: held to the float64 sum within
    # 1e-6 of the sum of |v| the key selects
    tol = np.array([1e-6 * np.abs(val[fk <= x]).sum(dtype=np.float64) + 1e-3
                    for x in keys * 0.5])
    cold = stmt.execute()
    warm = []
    for _ in range(WARM_ROUNDS):
        r = stmt.execute()
        check_loop_rows(r, expected, f"reduce kind at {rows} rows", tol)
        warm.append(r.elapsed_s * 1e3)
    check_loop_rows(cold, expected, f"reduce kind at {rows} rows cold", tol)
    out["reduce"] = {"rows": rows, "calling_rows": len(keys),
                     "cold_ms": cold.elapsed_s * 1e3, "warm_ms": float(np.median(warm)),
                     "warm_ms_all": warm}
    log(f"reduce kind at {rows} rows, {len(keys)} calling rows: FROID == the float64 sum; "
        f"cold {out['reduce']['cold_ms']:.1f} ms, warm median {out['reduce']['warm_ms']:.2f} ms "
        f"({', '.join(f'{w:.2f}' for w in warm)})")
    del s
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# correlated subqueries (torch.func.vmap over the outer rows)
# ---------------------------------------------------------------------------

#: the decorrelation oracle's shapes (``tests/conformance_util.py:741-775``):
#: kinds, correlation key shapes and the scalar subquery's aggregates
DECORR_KINDS = ("agg", "exists", "not_exists", "semi", "anti")
DECORR_KEYSHAPES = ("direct", "expr", "multi", "nonequi")
DECORR_AGGS = ("sum", "min", "max", "avg", "count")
#: the oracle's tables on the card: ``keys`` and ``facts`` rows
DECORR_ROWS = {"keys": 64, "facts": 20_000}
#: ``orders`` rows the SF-1 correlated queries run for
CORRELATED_OUTER_ROWS = 16


def decorr_query(kind: str, keyshape: str, agg: str = "sum", grouped: bool = False):
    """A copy of ``tests/conformance_util.py``'s ``decorr_query``
    (``:745-775``) on the port: one correlated statement over ``keys`` and
    ``facts``.  ``grouped`` (kind ``agg``): the subquery sums ``val`` per
    ``qty`` and returns the largest group sum."""
    import repro_torch.core as C
    from repro_torch.core import scalar as S

    outer = C.scan("keys")
    if keyshape == "direct":
        pred = C.col("fk") == S.Outer("k")
    elif keyshape == "expr":
        pred = C.col("fk") == S.Outer("k") + C.lit(3)
    elif keyshape == "multi":
        outer = outer.compute(kk=C.col("k") + C.lit(1))
        pred = (C.col("fk") == S.Outer("k")) & (C.col("qty") == S.Outer("kk"))
    else:  # nonequi: not decorrelatable, the per-row apply stays
        pred = C.col("fk") <= S.Outer("k")
    inner = C.scan("facts").filter(pred & (C.col("qty") >= C.param("minq")))
    if kind == "agg":
        if grouped:
            body = (inner.group_by("qty", capacity=9, g=C.sum_(C.col("val")))
                    .agg(s=C.max_(C.col("g"))))
        else:
            body = inner.agg(s={"sum": C.sum_, "min": C.min_, "max": C.max_, "avg": C.avg_,
                                "count": C.count_}[agg](C.col("val")))
        return outer.compute(out=C.scalar_subquery(body, "s")).project("k", "out")
    if kind == "exists":
        return outer.compute(out=C.exists(inner)).project("k", "out")
    if kind == "not_exists":
        return outer.compute(out=C.not_exists(inner)).project("k", "out")
    if kind == "semi":
        return outer.filter(C.exists(inner)).compute(out=C.col("k") * 2.0).project("k", "out")
    return outer.filter(C.not_exists(inner)).compute(out=C.col("k") * 2.0).project("k", "out")


def has_correlated_subquery(plan) -> bool:
    """Whether a subquery anywhere in ``plan`` still refers to outer-row
    columns: a per-row apply the decorrelation left in place."""
    from repro_torch.core import relalg as R
    from repro_torch.core import scalar as S
    from repro_torch.core.executor import _plan_outer_refs

    return any(isinstance(e, (S.ScalarSubquery, S.Exists)) and _plan_outer_refs(e.plan)
               for n in R.walk_plan_deep(plan) for ex in n.exprs() for e in S.walk(ex))


def per_row_plan(session, q):
    """The statement planned with the decorrelation rules off: the per-row
    apply (``tests/conformance_util.py``'s ``_per_row_reference``, ``:792``,
    on the port)."""
    from repro_torch.core import optimizer as O
    from repro_torch.core import relalg as R

    wanted = R.output_columns(q.node, session.catalog)
    rules = tuple(r for r in O.DEFAULT_RULES
                  if r not in (O.decorrelate_in_computes, O.decorrelate_filters))
    plan = O.optimize(q.node, session.catalog, required=set(wanted), rules=rules)
    if R.output_columns(plan, session.catalog) != wanted:
        plan = R.Project(plan, wanted)
    check(has_correlated_subquery(plan), "the per-row plan lost its correlated subquery")
    return plan


def run_plan(session, plan, params: dict, pallas_agg: bool):
    from repro_torch.core.executor import Executor
    from repro_torch.core.session import _param_value

    pv = {n: _param_value(v, session.device) for n, v in params.items()}
    return Executor(session.catalog, use_pallas_agg=pallas_agg,
                    device=session.device).execute(plan, params=pv)


def compare_masked(a, b, label: str, atol: float, rtol: float = 2e-3) -> None:
    """Two MaskedTables equal as the decorrelation oracle holds them
    (``conformance_util.assert_rows_equal``): masks and, on surviving rows,
    validity exactly; values where valid within ``rtol``/``atol``."""
    am, bm = a.mask.cpu().numpy(), b.mask.cpu().numpy()
    check(np.array_equal(am, bm), f"{label}: masks differ")
    check(sorted(a.table.names()) == sorted(b.table.names()), f"{label}: columns differ")
    for name in a.table.names():
        ca, cb = a.table.columns[name], b.table.columns[name]
        va, vb = ca.validity().cpu().numpy(), cb.validity().cpu().numpy()
        check(np.array_equal(va[am], vb[am]), f"{label}: validity of {name}")
        live = am & va
        xa = ca.data.cpu().numpy().astype(np.float64)[live]
        xb = cb.data.cpu().numpy().astype(np.float64)[live]
        check(np.allclose(xb, xa, rtol=rtol, atol=atol),
              f"{label}: {name} {xb.tolist()} vs {xa.tolist()}")


def decorr_oracle_on_card() -> dict:
    """The decorrelation oracle's shapes on the card: every kind and key
    shape with SUM, the five aggregates for ``agg``, and a grouped body,
    with ``pallas_agg`` off and on, for ``minq`` 0, 4 and 9.  FROID
    (decorrelated where the rule applies) == the per-row plan on the card
    == FROID on the CPU.  Floats within rtol 2e-3 (the harness's) and an
    atol of 1e-3 + 1e-6 x the sum of |val| over ``facts`` (a float32 sum's
    drift bound, as the reduce kind's)."""
    import repro_torch.core as C
    from repro_torch.kernels.relagg import ops

    rng = np.random.default_rng(0)
    n = DECORR_ROWS["facts"]
    facts = dict(fk=rng.integers(0, 7, n),
                 val=np.round(rng.uniform(-10, 10, n), 2).astype(np.float32),
                 qty=rng.integers(0, 9, n))
    keys = rng.integers(-2, 9, DECORR_ROWS["keys"])
    sessions = {}
    for device in (None, "cpu"):
        s = sessions[device] = C.Session(device=device)
        s.create_table("facts", **facts)
        s.create_table("keys", k=keys)
    atol = 1e-3 + 1e-6 * float(np.abs(facts["val"]).sum(dtype=np.float64))
    shapes = [(kind, ks, "sum", False) for kind in DECORR_KINDS for ks in DECORR_KEYSHAPES]
    shapes += [("agg", ks, agg, False) for ks in ("direct", "nonequi")
               for agg in DECORR_AGGS if agg != "sum"]
    shapes += [("agg", ks, "sum", True) for ks in ("direct", "nonequi")]
    card, cpu = sessions[None], sessions["cpu"]
    t0 = time.perf_counter()
    runs = 0
    ops.BATCHED_LAUNCHES = 0
    for kind, ks, agg, grouped in shapes:
        label = f"decorr {kind}/{ks}/{agg}{'/grouped' if grouped else ''}"
        q = decorr_query(kind, ks, agg, grouped)
        for pallas in ((False, True) if grouped else (False,)):
            policy = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True) if pallas \
                else C.FROID
            froid, froid_cpu = card.prepare(q, policy), cpu.prepare(q, policy)
            per_row = ks == "nonequi" or grouped  # no rule rewrites these
            check(has_correlated_subquery(froid.plan) == per_row,
                  f"{label}: FROID's plan {'lost' if per_row else 'kept'} its correlated "
                  "subquery")
            plan = per_row_plan(card, q)
            for minq in (0, 4, 9):
                p = {"minq": minq}
                got = froid.execute(params=p)
                check_on_card(got, label)
                compare_masked(run_plan(card, plan, p, pallas), got.masked,
                               f"{label} minq={minq} FROID vs per-row", atol)
                compare_masked(froid_cpu.execute(params=p).masked, got.masked,
                               f"{label} minq={minq} card vs CPU", atol)
                runs += 1
    check(ops.BATCHED_LAUNCHES > 0, "decorrelation oracle: the grouped body with pallas_agg "
          "on did not launch relagg batched")
    out = {"shapes": len(shapes), "runs": runs, "keys": DECORR_ROWS["keys"], "facts": n,
           "relagg_batched_launches": ops.BATCHED_LAUNCHES,
           "seconds": time.perf_counter() - t0}
    log(f"decorrelation oracle on the card: {len(shapes)} shapes x 3 minq ({runs} runs, "
        f"{n} facts rows, {len(keys)} keys rows): FROID == per-row == CPU; relagg batched "
        f"launches {ops.BATCHED_LAUNCHES}; {out['seconds']:.1f} s")
    return out


def correlated_queries():
    """The SF-1 correlated statements over ``lineitem`` for each row of
    ``orders16``, a non-equi correlation (``l_shipdate <= o_orderdate``)
    that no rule decorrelates: (a) a full-table SUM of the discounted
    price, (b) the same grouped by ``l_shipmode`` (7 groups), then the
    largest group's sum, (c) EXISTS."""
    import repro_torch.core as C
    from repro_torch.core import scalar as S

    price = C.col("l_extendedprice") * (C.lit(1.0) - C.col("l_discount"))
    inner = C.scan("lineitem").filter(C.col("l_shipdate") <= S.Outer("o_orderdate"))
    outer = C.scan("orders16")
    return {
        "full_agg": outer.compute(out=C.scalar_subquery(inner.agg(s=C.sum_(price)), "s")),
        "grouped": outer.compute(out=C.scalar_subquery(
            inner.group_by("l_shipmode", g=C.sum_(price)).agg(s=C.max_(C.col("g"))), "s")),
        "exists": outer.compute(out=C.exists(inner)),
    }


def correlated_expected(session, dates):
    """Each outer row's answers in float64 on the host: (a)'s sum, (b)'s
    largest group sum (NaN where no row qualifies), (c)'s EXISTS, and the
    tolerance 1e-6 x the sum of |v| the row selects + 1e-3 (the reduce
    kind's)."""
    li = session.catalog["lineitem"].columns
    ship = li["l_shipdate"].data.cpu().numpy()
    v = (li["l_extendedprice"].data.cpu().numpy().astype(np.float64)
         * (1.0 - li["l_discount"].data.cpu().numpy().astype(np.float64)))
    mode = li["l_shipmode"].data.cpu().numpy()
    groups = len(li["l_shipmode"].dictionary)
    out = {"full_agg": [], "grouped": [], "exists": [], "tol": []}
    for d in dates:
        sel = ship <= d
        out["full_agg"].append(v[sel].sum())
        present = np.bincount(mode[sel], minlength=groups) > 0
        sums = np.bincount(mode[sel], weights=v[sel], minlength=groups)
        out["grouped"].append(sums[present].max() if present.any() else np.nan)
        out["exists"].append(bool(sel.any()))
        out["tol"].append(1e-6 * np.abs(v[sel]).sum() + 1e-3)
    return {k: np.asarray(x) for k, x in out.items()}


def check_correlated(masked, name: str, expected, label: str) -> None:
    """A correlated statement's result (a MaskedTable, every outer row kept)
    against :func:`correlated_expected`: validity and EXISTS exactly, sums
    within the tolerance."""
    check(bool(masked.mask.all()), f"{label}: an outer row was masked out")
    col = masked.table.columns["out"]
    data = col.data.cpu().numpy()
    valid = col.validity().cpu().numpy()
    want = expected[name]
    if name == "exists":
        check(np.array_equal(data, want) and valid.all(), f"{label}: {data.tolist()} vs "
              f"{want.tolist()}")
        return
    has = ~np.isnan(want) if name == "grouped" else expected["exists"]
    check(np.array_equal(valid, has), f"{label}: validity {valid.tolist()}")
    err = np.abs(data.astype(np.float64)[has] - want[has])
    check(bool((err <= expected["tol"][has]).all()) and np.isfinite(data[has]).all(),
          f"{label}: {data[has].tolist()} vs {want[has].tolist()}")


def time_relagg_batched(args, expected_groups: int) -> dict:
    """relagg's batched kernel at the inputs (b) handed it: checked against
    the plain batched version and the float64 sums, then timed in turns
    with it (plain, kernel, kernel, plain) and beside ``index_add_`` on
    the same inputs.  Two bounds: ``bound_ms`` counts each input byte
    once (the whole batched mask; gid where any item's mask is set and
    vals where any item selects a row, since every item reads one stored
    copy; the output), ``bound_per_item_ms`` what B unbatched calls
    would read (each item's mask, gid where its mask is set, vals of its
    selected rows), which a stride-0 input costs unless L2 holds it."""
    import torch

    from repro_torch.kernels.relagg.ref import grouped_aggregate_batched_ref
    from repro_torch.kernels.relagg.relagg import relagg_cuda_batched, uses_shared

    gid, mask, vals, G = args
    B, n, k = vals.shape
    check(G == expected_groups, f"relagg batched at (b): G = {G}")
    out = relagg_cuda_batched(gid, mask, vals, G).cpu().numpy()
    ps, pc = (t.cpu().numpy() for t in grouped_aggregate_batched_ref(gid, mask, vals, G))
    sel = mask & (gid >= 0) & (gid < G)
    # on the host, one copy of an input every item shares (stride 0)
    host = {name: (t[0].cpu().numpy() if t.stride(0) == 0 else None, t)
            for name, t in (("gid", gid), ("vals", vals))}
    masks = mask.cpu().numpy()
    err, worst = 0.0, 0.0
    for b in range(B):
        g, v = (one if one is not None else t[b].cpu().numpy()
                for one, t in (host["gid"], host["vals"]))
        ref_sums, absum, counts = f64_reference(g, masks[b], v, G)
        kc, ks = out[b, :, k], out[b, :, :k].astype(np.float64)
        check(np.array_equal(kc, pc[b]) and np.array_equal(kc, counts.astype(np.float32)),
              f"relagg batched at (b), item {b}: counts differ")
        e = np.abs(ks - ps[b])
        check((e <= 1e-4 * absum).all() and (np.abs(ks - ref_sums) <= 1e-4 * absum).all(),
              f"relagg batched at (b), item {b}: sums off the plain version or float64")
        err = max(err, float(e.max(initial=0.0)))
        worst = max(worst, float(np.max(e / np.maximum(absum, 1e-30), initial=0.0)))
    slot = torch.where(sel, gid.to(torch.int64)
                       + torch.arange(B, device=gid.device).reshape(B, 1) * G, 0).reshape(-1)
    src = torch.cat([torch.where(sel[..., None], vals, 0.0), sel[..., None].float()],
                    -1).reshape(B * n, k + 1)

    def library():
        return torch.zeros((B * G, k + 1), device=vals.device).index_add_(0, slot, src)

    def kernel():
        return relagg_cuda_batched(gid, mask, vals, G)

    def plain():
        return grouped_aggregate_batched_ref(gid, mask, vals, G)

    p1 = cuda_ms(plain, reps=3, warmup=1)
    k1, k2 = cuda_ms(kernel), cuda_ms(kernel)
    p2 = cuda_ms(plain, reps=3, warmup=1)
    lib_ms = cuda_ms(library, reps=3, warmup=1)
    split = relagg_split(kernel)
    set_rows = mask.sum(1)
    any_set = mask.any(0)
    any_sel = sel.any(0)
    out_bytes = B * G * (k + 1) * 4
    once = B * n + int(any_set.sum()) * 4 + int(any_sel.sum()) * 4 * k + out_bytes
    per_item = B * n + int(set_rows.sum()) * 4 + int(sel.sum()) * 4 * k + out_bytes
    ops_count = int(sel.sum()) * (k + 1)
    bound_ops_ms = ops_count / F32_OPS_PER_S * 1e3
    bound_once_ms = once / HBM_BYTES_PER_S * 1e3
    return {
        "B": B, "n": n, "groups": G, "k": k, "path": "shared" if uses_shared(G, k) else "global",
        "selected": int(sel.sum()), "mask_set": int(set_rows.sum()),
        "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
        "bound_ms": max(bound_once_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_once_ms >= bound_ops_ms else "operations",
        "bytes": once, "bytes_per_item": per_item,
        "bound_per_item_ms": max(per_item / HBM_BYTES_PER_S * 1e3, bound_ops_ms),
        "max_abs_err": err, "max_err_over_abs_sum": worst,
        "device_ms": split["device_ms"], "host_ms_per_call": split["host_ms_per_call"],
        "launches_per_call": split["launches_per_call"],
    }


def correlated_phase(full) -> dict:
    """Correlated subqueries on the card, each one ``torch.func.vmap`` of
    its subplan over the outer rows.  (1) The decorrelation oracle's shapes
    (:func:`decorr_oracle_on_card`).  (2) At SF 1, over ``lineitem``'s
    6,000,000 rows for 16 ``orders`` rows (dates spread from the earliest
    to the latest): :func:`correlated_queries` under FROID, (b) with
    ``pallas_agg`` on (relagg launches batched: ``BATCHED_LAUNCHES`` read
    before and after) and off, each held to its float64 answer; warm ms;
    one warm run of each under ``torch.cuda.set_sync_debug_mode("error")``;
    relagg's batched call at (b)'s inputs timed (:func:`time_relagg_batched`)."""
    import torch

    import repro_torch.core as C
    from repro_torch.core.executor import Executor
    from repro_torch.kernels.relagg import ops
    from repro_torch.kernels.relagg import relagg as binding

    t0 = time.perf_counter()
    out = {"oracle": decorr_oracle_on_card()}
    orders = full.catalog["orders"].columns
    odate = orders["o_orderdate"].data.cpu().numpy()
    pick = np.argsort(odate, kind="stable")[
        np.linspace(0, len(odate) - 1, CORRELATED_OUTER_ROWS).astype(np.int64)]
    full.create_table("orders16", o_orderkey=orders["o_orderkey"].data.cpu().numpy()[pick],
                      o_orderdate=odate[pick])
    expected = correlated_expected(full, odate[pick])
    check(not expected["exists"].all() and expected["exists"].any(),
          "the 16 outer rows should hold an EXISTS of each value")
    relagg_on = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    queries = correlated_queries()
    sf1: dict = {"outer_rows": CORRELATED_OUTER_ROWS,
                 "lineitem_rows": full.catalog["lineitem"].num_rows}
    for name, q in queries.items():
        for label, policy, rounds in (("on", relagg_on, WARM_ROUNDS), ("off", C.FROID, 2)):
            if name != "grouped" and label == "off":
                continue
            check(has_correlated_subquery(full.prepare(q, policy).plan),
                  f"{name}: FROID decorrelated the non-equi correlation")
            before = ops.LAUNCHES
            ops.BATCHED_LAUNCHES = 0  # counts this statement's runs only
            cold, warm_ms = run_statement(full, q, policy, rounds)
            batched = ops.BATCHED_LAUNCHES
            key = name if name != "grouped" else f"grouped/relagg_{label}"
            tag = f"correlated {key} at SF 1"
            check_on_card(cold, tag)
            check_correlated(cold.masked, name, expected, tag)
            sf1[key] = {"cold_ms": cold.elapsed_s * 1e3, "warm_ms": warm_ms,
                        "relagg_batched_launches": batched,
                        "relagg_launches": ops.LAUNCHES - before}
            if name == "grouped":
                check((batched > 0) == (label == "on") and batched == ops.LAUNCHES - before,
                      f"{tag}: relagg batched launches {batched}, all {ops.LAUNCHES - before}")
            log(f"{tag}: == float64 per outer row; warm {warm_ms:.2f} ms (cold "
                f"{cold.elapsed_s * 1e3:.1f}), relagg batched launches {batched}")
    # the warm runs through the executor alone, under the sync check
    for name, q in queries.items():
        pallas = name == "grouped"
        plan = full.prepare(q, relagg_on if pallas else C.FROID).plan
        ex = Executor(full.catalog, use_pallas_agg=pallas, device=full.device)
        ex.execute(plan)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = ex.execute(plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host_ms = (time.perf_counter() - t1) * 1e3
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t1) * 1e3
        check_correlated(res, name, expected, f"correlated {name} under the sync check")
        sf1[f"{name}/sync_check"] = {"host_ms": host_ms, "total_ms": total_ms}
        log(f"correlated {name} at SF 1 under set_sync_debug_mode('error'): no host sync; "
            f"issued in {host_ms:.2f} ms, done in {total_ms:.2f} ms")
    # relagg's batched call at (b)'s inputs
    captured = []
    launch = binding.relagg_cuda_batched

    def recording(gid, mask, vals, num_groups):
        captured.append((gid, mask, vals, num_groups))
        return launch(gid, mask, vals, num_groups)

    binding.relagg_cuda_batched = recording
    try:
        full.execute(queries["grouped"], relagg_on)
    finally:
        binding.relagg_cuda_batched = launch
    check(len(captured) == 1, f"(b): {len(captured)} batched relagg calls")
    t = sf1["relagg_batched"] = time_relagg_batched(
        captured[0], len(full.catalog["lineitem"].columns["l_shipmode"].dictionary))
    log(f"relagg batched at (b)'s inputs (B={t['B']}, n={t['n']}, G={t['groups']}, "
        f"k={t['k']}, {t['path']} path, {t['selected']} rows selected over the items): == "
        f"plain (max abs err {t['max_abs_err']:.3g}, {t['max_err_over_abs_sum']:.3g} of its "
        f"group's sum of |v|); kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}, host "
        f"{t['host_ms_per_call']:.4f}), plain {t['plain_ms']:.3f} ms, index_add_ "
        f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms ({t['bytes'] / 1e6:.1f} MB "
        f"each byte once; {t['bound_per_item_ms']:.5f} ms, {t['bytes_per_item'] / 1e6:.1f} "
        f"MB, item by item)")
    del captured
    out["sf1"] = sf1
    out["seconds"] = time.perf_counter() - t0
    log(f"correlated phase ok in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# invocation phase: execute_many, execute_async and the scheduler
# ---------------------------------------------------------------------------

#: ``benchmarks/bench_execute_many.py:45-75``'s tables, ``detail`` at SF 1
#: ``lineitem``'s row count
INVOCATION_ROWS = {"detail": 6_000_000, "T": 2_000, "keys": 400}
INVOCATION_SWEEP = (1, 32, 1024)


def invocation_session(detail_rows: int = INVOCATION_ROWS["detail"], device=None):
    """``bench_execute_many._setup`` at ``detail``'s real scale (numpy,
    seed 0) on the card (or ``device``), with its ``key_total`` UDF; and
    ``T``'s host array, the float64 sums of ``d_val`` by key and their
    tolerance for the float64 check."""
    import repro_torch.core as C

    db = C.Session(device=device)
    return (db, *load_invocation(db, detail_rows))


def load_invocation(db, detail_rows: int = INVOCATION_ROWS["detail"]):
    """:func:`invocation_session`'s tables and UDF loaded into ``db``; returns
    ``T``'s host array, the float64 sums and their tolerance."""
    import repro_torch.core as C

    rows, keys = detail_rows, INVOCATION_ROWS["keys"]
    rng = np.random.default_rng(0)
    d_key = rng.integers(0, keys, rows)
    d_val = rng.uniform(0, 100, rows).astype(np.float32)
    a = rng.integers(0, keys, INVOCATION_ROWS["T"])
    db.create_table("detail", d_key=d_key, d_val=d_val)
    db.create_table("T", a=a)
    u = C.UdfBuilder("key_total", [("k", "int32")], "float32")
    u.declare("s", "float32")
    u.select({"s": C.sum_(C.col("d_val"))}, frm=C.scan("detail"),
             where=C.col("d_key") == C.param("k"))
    with u.if_(C.var("s").is_null()):
        u.return_(C.lit(0.0))
    u.return_(C.var("s"))
    db.create_function(u.build())
    sums = np.bincount(d_key, weights=d_val.astype(np.float64), minlength=keys)
    tol = 1e-6 * np.bincount(d_key, weights=np.abs(d_val.astype(np.float64)),
                             minlength=keys) + 1e-3
    return a, sums, tol


def key_total_query():
    import repro_torch.core as C

    return (C.scan("T").filter(C.col("a") < C.param("cutoff"))
            .compute(v=C.udf("key_total", C.col("a"))).project("v"))


def stacked(results, column: str):
    """(masks (N, n), values (N, n)) of N results, on the host (the results
    of a mesh over several cards gathered onto the first's device)."""
    import torch

    masked = [r.masked for r in results]
    dev = masked[0].mask.device
    return (torch.stack([m.mask.to(dev) for m in masked]).cpu().numpy(),
            torch.stack([m.table.columns[column].data.to(dev) for m in masked]).cpu().numpy())


def check_key_totals(results, cutoffs, a, sums, tol, label: str):
    """Each ticket: its mask is ``a < cutoff`` and ``v`` the float64 sum of
    ``d_val`` over its key, within ``tol``."""
    masks, vals = stacked(results, "v")
    want = a[None, :] < np.asarray(cutoffs)[:, None]
    check(np.array_equal(masks, want), f"{label}: masks differ from a < cutoff")
    err = np.abs(vals.astype(np.float64) - sums[a][None, :])
    check(bool((err <= tol[a][None, :])[want].all()) and np.isfinite(vals[want]).all(),
          f"{label}: a value off its float64 sum (max err {float(err[want].max()):.3g})")
    return masks, vals


def same_tickets(a_results, b_results, column: str, label: str, exact: bool) -> float:
    """Two result lists element-wise: masks exactly, ``column`` bit-equal
    (``exact``) or to rtol 1e-5 where selected; returns the max |diff|."""
    am, av = stacked(a_results, column)
    bm, bv = stacked(b_results, column)
    check(np.array_equal(am, bm), f"{label}: masks differ")
    diff = np.abs(av.astype(np.float64) - bv.astype(np.float64))[am]
    if exact:
        check(np.array_equal(av[am], bv[am]), f"{label}: values not bit-equal "
              f"(max |diff| {float(diff.max(initial=0.0)):.3g})")
    else:
        check(np.allclose(av[am], bv[am], rtol=1e-5), f"{label}: values differ")
    return float(diff.max(initial=0.0))


def arm(fn) -> dict:
    """``fn()`` once on the host clock (it ends waiting for its device
    work), with the peak device memory and relagg's launches in it."""
    import torch

    from repro_torch.kernels.relagg import ops

    cuda = torch.cuda.is_available()  # off the card: a CPU rehearsal
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = ops.BATCHED_LAUNCHES = 0  # counts this arm only
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    return {"out": out, "wall_s": wall, "relagg_launches": ops.LAUNCHES,
            "relagg_batched_launches": ops.BATCHED_LAUNCHES,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}


def serial_split(stmt, params_list) -> tuple[float, float]:
    """The serial loop's dispatch and sync seconds apart: the raw call
    (``stmt(params)``, every operator queued) and the wait after it."""
    import torch

    dispatch = sync = 0.0
    for p in params_list:
        t0 = time.perf_counter()
        stmt(params=p)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        dispatch += t1 - t0
        sync += time.perf_counter() - t1
    return dispatch, sync


def dispatch_without_sync(stmt, params_list) -> tuple[list, float]:
    """One ``execute_many`` chunk's dispatch under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises),
    then its barrier outside it: (results, host ms of the dispatch)."""
    import torch

    from repro_torch.core.session import param_signature

    env = stmt.session._env_token()
    pending: list = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stmt._dispatch_batch(list(range(len(params_list))), params_list,
                             param_signature(params_list[0]), env, pending,
                             stmt.policy.max_batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_ms = (time.perf_counter() - t0) * 1e3
    check(len(pending) == 1, f"{len(pending)} chunks for {len(params_list)} tickets")
    results = [None] * len(params_list)
    stmt._finalize_batch(pending[0], results, 1)
    return results, host_ms


def key_total_phase() -> dict:
    """(a): the serial ``execute`` loop, ``execute_many`` and N
    ``execute_async`` calls then their results, at N = 1, 32 and 1,024
    (``bench_execute_many``'s cutoffs: numpy seed 7), FROID with relagg
    on; each ticket against the float64 sums, the batched and async
    results against the serial loop; then the padding (N = 33 in bucket
    64 against N = 32) and the sync check of one chunk's and one async
    dispatch."""
    import torch

    import repro_torch.core as C

    db, a, sums, tol = invocation_session()
    policy = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    stmt = db.prepare(key_total_query(), policy)
    stmt.execute(params={"cutoff": 1})  # the plan and the catalog arguments
    rng = np.random.default_rng(7)
    out: dict = {"rows": dict(INVOCATION_ROWS), "sweep": {}}
    for n in INVOCATION_SWEEP:
        cutoffs = rng.integers(1, INVOCATION_ROWS["keys"], n)
        plist = [{"cutoff": int(c)} for c in cutoffs]
        serial = arm(lambda: [stmt.execute(params=p) for p in plist])
        check_key_totals(serial["out"], cutoffs, a, sums, tol, f"serial N={n}")
        s_dispatch, s_sync = serial_split(stmt, plist)
        stmt.execute_many(plist)  # the first call of this bucket
        many = arm(lambda: stmt.execute_many(plist))
        check_key_totals(many["out"], cutoffs, a, sums, tol, f"execute_many N={n}")
        many_diff = same_tickets(serial["out"], many["out"], "v",
                                 f"execute_many vs serial N={n}", exact=False)
        st = many["out"][0].stats
        check(st["batch_size"] == n and st["batch_bucket"] == C.batch_bucket(n, 1024),
              f"execute_many N={n}: {st}")

        def run_async():
            futs = [stmt.execute_async(params=p) for p in plist]
            return [f.result() for f in futs]

        asyn = arm(run_async)
        check_key_totals(asyn["out"], cutoffs, a, sums, tol, f"async N={n}")
        async_diff = same_tickets(serial["out"], asyn["out"], "v",
                                  f"async vs serial N={n}", exact=True)
        check(serial["relagg_launches"] == n and asyn["relagg_launches"] == n
              and many["relagg_launches"] == 1 and many["relagg_batched_launches"] == 0,
              f"N={n}: relagg launches serial {serial['relagg_launches']}, "
              f"execute_many {many['relagg_launches']} "
              f"({many['relagg_batched_launches']} batched), async {asyn['relagg_launches']}")
        row = {}
        for name, r, dispatch, sync in (
                ("serial", serial, s_dispatch, s_sync),
                ("execute_many", many, st["dispatch_s"], st["sync_s"]),
                ("async", asyn, sum(x.stats["dispatch_s"] for x in asyn["out"]),
                 sum(x.stats["sync_s"] for x in asyn["out"]))):
            row[name] = {"us_per_invocation": r["wall_s"] / n * 1e6, "wall_ms": r["wall_s"] * 1e3,
                         "dispatch_s": dispatch, "sync_s": sync,
                         "batch_bucket": r["out"][0].stats.get("batch_bucket"),
                         "relagg_launches": r["relagg_launches"], "peak_gb": r["peak_gb"]}
        row["max_abs_diff_vs_serial"] = {"execute_many": many_diff, "async": async_diff}
        out["sweep"][n] = row
        log(f"invocation (a) N={n}: µs an invocation serial {row['serial']['us_per_invocation']:.1f}"
            f", execute_many {row['execute_many']['us_per_invocation']:.1f} (bucket "
            f"{row['execute_many']['batch_bucket']}, dispatch {st['dispatch_s'] * 1e3:.2f} ms, "
            f"sync {st['sync_s'] * 1e3:.2f} ms), async {row['async']['us_per_invocation']:.1f}; "
            f"relagg launches {serial['relagg_launches']} / {many['relagg_launches']} / "
            f"{asyn['relagg_launches']}; peak GB {serial['peak_gb']:.3f} / "
            f"{many['peak_gb']:.3f} / {asyn['peak_gb']:.3f}; == float64 and serial")
        del serial, many, asyn
    # the padding: N = 32 (bucket 32) and N = 33 (bucket 64), in turns
    pad: dict = {32: [], 33: []}
    cutoffs = rng.integers(1, INVOCATION_ROWS["keys"], 33)
    lists = {n: [{"cutoff": int(c)} for c in cutoffs[:n]] for n in pad}
    for n in pad:
        stmt.execute_many(lists[n])
    for _ in range(3):
        for n in (32, 33, 33, 32):
            r = arm(lambda n=n: stmt.execute_many(lists[n]))
            pad[n].append(r["wall_s"] * 1e3)
            check(r["out"][0].stats["batch_bucket"] == (32 if n == 32 else 64), "padding")
    out["padding"] = {f"N{n}_ms": float(np.median(v)) for n, v in pad.items()}
    out["padding"]["N33_over_N32"] = out["padding"]["N33_ms"] / out["padding"]["N32_ms"]
    log(f"invocation (a) padding: N=32 in bucket 32 {out['padding']['N32_ms']:.3f} ms, N=33 in "
        f"bucket 64 {out['padding']['N33_ms']:.3f} ms (x{out['padding']['N33_over_N32']:.3f})")
    # no host sync in a chunk's dispatch or an async dispatch
    results, many_host_ms = dispatch_without_sync(stmt, lists[32])
    check_key_totals(results, cutoffs[:32], a, sums, tol, "execute_many under the sync check")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = stmt.execute_async(params=lists[32][0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    async_host_ms = (time.perf_counter() - t0) * 1e3
    check_key_totals([fut.result()], cutoffs[:1], a, sums, tol, "execute_async under the sync check")
    out["sync_check_host_ms"] = {"execute_many_chunk_32": many_host_ms,
                                 "execute_async": async_host_ms}
    log(f"invocation (a) under set_sync_debug_mode('error'): no host sync; a 32-ticket "
        f"chunk dispatched in {many_host_ms:.2f} ms, an async call in {async_host_ms:.2f} ms")
    del db, stmt, results, fut
    return out


def grouped_param_expected(session, dates):
    """(b)'s answer per date in float64 on the host: the discounted price
    summed by ``l_shipmode`` code over ``l_shipdate <= d``, which groups
    are present, and the tolerance (1e-6 x the group's sum of |v| +
    1e-3)."""
    li = session.catalog["lineitem"].columns
    ship = li["l_shipdate"].data.cpu().numpy()
    v = (li["l_extendedprice"].data.cpu().numpy().astype(np.float64)
         * (1.0 - li["l_discount"].data.cpu().numpy().astype(np.float64)))
    mode = li["l_shipmode"].data.cpu().numpy()
    groups = len(li["l_shipmode"].dictionary)
    out = []
    for d in dates:
        sel = ship <= d
        out.append((np.bincount(mode[sel], weights=v[sel], minlength=groups),
                    np.bincount(mode[sel], minlength=groups) > 0,
                    1e-6 * np.bincount(mode[sel], weights=np.abs(v[sel]), minlength=groups)
                    + 1e-3))
    return out


def check_grouped_param(results, expected, label: str) -> None:
    """Each ticket of (b): the groups present are the float64 answer's, and
    each group's sum is within its tolerance (rows matched by key)."""
    for i, (r, (sums, present, tol)) in enumerate(zip(results, expected)):
        m = r.masked
        mask = m.mask.cpu().numpy()
        keys = m.table.columns["l_shipmode"].data.cpu().numpy()[mask]
        g = m.table.columns["g"].data.cpu().numpy()[mask].astype(np.float64)
        check(sorted(keys.tolist()) == np.flatnonzero(present).tolist(),
              f"{label}[{i}]: groups {sorted(keys.tolist())}")
        err = np.abs(g - sums[keys])
        check(bool((err <= tol[keys]).all()) and np.isfinite(g).all(),
              f"{label}[{i}]: sums off float64 by {float(err.max(initial=0.0)):.3g}")


def grouped_param_phase(full) -> dict:
    """(b): ``lineitem`` at SF 1 filtered by ``l_shipdate <= param("d")``,
    grouped by ``l_shipmode``, the discounted price summed, through
    ``execute_many`` over the correlated phase's 16 dates: relagg on (the
    parameter reaches relagg's batch axis: one batched launch a chunk)
    and off; each ticket against float64 and the serial loop; warm ms;
    one chunk's dispatch under the sync check."""
    import repro_torch.core as C

    dates = full.catalog["orders16"].columns["o_orderdate"].data.cpu().numpy()
    plist = [{"d": int(d)} for d in dates]
    expected = grouped_param_expected(full, dates)
    price = C.col("l_extendedprice") * (C.lit(1.0) - C.col("l_discount"))
    q = (C.scan("lineitem").filter(C.col("l_shipdate") <= C.param("d"))
         .group_by("l_shipmode", g=C.sum_(price)))
    out: dict = {"tickets": len(plist), "lineitem_rows": full.catalog["lineitem"].num_rows}
    for label, pallas, rounds in (("relagg_on", True, WARM_ROUNDS), ("relagg_off", False, 2)):
        stmt = full.prepare(q, C.ExecutionPolicy(name=f"froid+{label}", pallas_agg=pallas))
        serial = [stmt.execute(params=p) for p in plist]
        check_grouped_param(serial, expected, f"(b) serial {label}")
        first = stmt.execute_many(plist)
        warm = [arm(lambda: stmt.execute_many(plist)) for _ in range(rounds)]
        batched = warm[-1]["out"]
        check_grouped_param(batched, expected, f"(b) execute_many {label}")
        diff = same_tickets(serial, batched, "g", f"(b) execute_many vs serial {label}",
                            exact=pallas)
        chunks = {r.stats["pipelined_chunks"] for r in batched}
        launches = [w["relagg_batched_launches"] for w in warm]
        check(launches == ([1] * rounds if pallas else [0] * rounds) and chunks == {1},
              f"(b) {label}: batched relagg launches a call {launches}, chunks {chunks}")
        out[label] = {"warm_ms": float(np.median([w["wall_s"] * 1e3 for w in warm])),
                      "warm_ms_all": [w["wall_s"] * 1e3 for w in warm],
                      "first_ms": first[0].elapsed_s * 1e3,
                      "dispatch_ms": batched[0].stats["dispatch_s"] * 1e3,
                      "sync_ms": batched[0].stats["sync_s"] * 1e3,
                      "batch_bucket": batched[0].stats["batch_bucket"],
                      "relagg_batched_launches_per_call": launches[0],
                      "relagg_launches_per_call": warm[0]["relagg_launches"],
                      "peak_gb": warm[-1]["peak_gb"], "max_abs_diff_vs_serial": diff}
        if pallas:
            results, host_ms = dispatch_without_sync(stmt, plist)
            check_grouped_param(results, expected, "(b) under the sync check")
            out[label]["sync_check_host_ms"] = host_ms
        log(f"invocation (b) {label}: 16 dates x {out['lineitem_rows']} rows, execute_many warm "
            f"{out[label]['warm_ms']:.2f} ms (first {out[label]['first_ms']:.1f}), bucket "
            f"{out[label]['batch_bucket']}, relagg batched launches a call {launches[0]}, "
            f"peak {out[label]['peak_gb']:.3f} GB; == float64 and the serial loop "
            f"({'bit-equal' if pallas else 'max |diff| %.3g' % diff})"
            + (f"; a chunk dispatched with no host sync in {host_ms:.2f} ms" if pallas else ""))
        del serial, first, warm, batched
    return out


def admission_phase() -> dict:
    """(c): ``AdmissionPolicy.evaluate_coalesced`` (per-request submits,
    one scheduler drain through ``execute_many``) against ``evaluate``
    (the tick path) and the rules written out in Python, on the serving
    phase's 9 requests, under FROID, INTERPRETED and HEKATON on the card;
    each path's host ms (3 warm calls, median)."""
    from repro_torch.configs import config_for
    from repro_torch.serve.admission import AdmissionPolicy

    reqs = serve_requests(config_for("granite3_2b").vocab)
    fields = {"tier": np.array([r.tier for r in reqs]),
              "prompt_len": np.array([len(r.prompt) for r in reqs]),
              "max_new_tokens": np.array([r.max_new_tokens for r in reqs]),
              "temperature": np.array([r.temperature for r in reqs])}
    want = [expected_verdict(r.tier, len(r.prompt), r.max_new_tokens, r.temperature, len(reqs))
            for r in reqs]
    out = {}
    for policy in ("froid", "interpreted", "hekaton"):
        ap = AdmissionPolicy(policy=policy)
        times: dict = {"tick": [], "coalesced": []}
        for _ in range(4):
            for path, fn in (("tick", ap.evaluate), ("coalesced", ap.evaluate_coalesced)):
                t0 = time.perf_counter()
                got = fn(fields)
                times[path].append((time.perf_counter() - t0) * 1e3)
                check([(bool(a), int(g)) for a, g in zip(got["admit"], got["granted"])]
                      == [(a, g) for a, g, _ in want]
                      and np.allclose(got["temp"], [t for _, _, t in want], rtol=1e-6),
                      f"admission {policy} {path}: {got} vs the rules")
        stmt = ap.request_statement()
        check(stmt.policy.compile_plan and ap.scheduler.stats["batches"] == 4
              and ap.scheduler.stats["drained"] == 4 * len(reqs),
              f"admission {policy}: {stmt.policy.name}, {ap.scheduler.stats}")
        out[policy] = {path: {"first_ms": t[0], "warm_ms": float(np.median(t[1:]))}
                       for path, t in times.items()}
        log(f"invocation (c) admission {policy}: coalesced == tick == the rules; host ms tick "
            f"{out[policy]['tick']['warm_ms']:.2f} (first {out[policy]['tick']['first_ms']:.1f}),"
            f" through the scheduler {out[policy]['coalesced']['warm_ms']:.2f} (first "
            f"{out[policy]['coalesced']['first_ms']:.1f}; {stmt.policy.name})")
        del ap
    return out


def invocation_phase(full) -> dict:
    """``execute_many``, ``execute_async`` and the scheduler on the card:
    (a) :func:`key_total_phase`, (b) :func:`grouped_param_phase` (on the
    SF-1 session, after the correlated phase made ``orders16``), (c)
    :func:`admission_phase` (``ServeEngine.submit``/``drain`` runs in the
    granite serving phase, :func:`intake_check`)."""
    import torch

    t0 = time.perf_counter()
    out = {"key_total": key_total_phase()}
    gc.collect()
    torch.cuda.empty_cache()
    out["grouped"] = grouped_param_phase(full)
    out["admission"] = admission_phase()
    out["seconds"] = time.perf_counter() - t0
    log(f"invocation phase ok in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# fused phase: execute_fused, the scheduler's fused drains
# ---------------------------------------------------------------------------

#: ``benchmarks/bench_fused.py``'s tickets a statement and serial prefix
FUSED_PER_STMT = 64
FUSED_SERIAL_N = 48
#: warm drains timed per arm
FUSED_DRAINS = 5
#: the overlap queue's fused wave: its pool evaluations (the four shared
#: constant subtrees — the scans of ``T`` and ``detail``, the ``detail``
#: build's GroupAgg and its Project — and the unified template once at each
#: distinct cutoff) and its distinct cutoffs, as ``tests/test_torch_fused.py``
#: finds them on the CPU
OVERLAP_POOL_EVALS = 12
OVERLAP_BINDINGS = 8
#: the fusion oracle's tables at the card's size: ``facts`` rows
FUSION_FACTS_ROWS = 20_000


def fused_queries():
    """``benchmarks/bench_fused.py:89-106``'s ``_queries`` on
    ``repro_torch.core``: six different statements over ``T`` (and
    ``detail`` through ``key_total``), one parameter-free."""
    import repro_torch.core as C

    col, param, udf = C.col, C.param, C.udf
    return [
        C.scan("T").filter(col("a") < param("cutoff"))
                   .compute(v=udf("key_total", col("a"))).project("v"),
        C.scan("T").filter(col("a") >= param("lo"))
                   .compute(w=col("a") * param("scale")).project("a", "w"),
        C.scan("T").compute(v=udf("key_total", col("a")) / param("div"))
                   .project("v"),
        C.scan("T").filter((col("a") > param("lo")) & (col("a") < param("hi")))
                   .compute(z=col("a") + param("off")).project("z"),
        C.scan("T").compute(b=col("a") * 2).project("b"),  # parameter-free
        C.scan("T").filter(col("a") % param("mod") == C.lit(0))
                   .compute(v=udf("key_total", col("a"))).project("a", "v"),
    ]


def overlap_queries():
    """``bench_fused.py:109-122``'s ``_overlap_queries``: six statements
    calling ``key_total`` under ``a < Param(c_i)``, one template across
    all six."""
    import repro_torch.core as C

    def q(i):
        return (C.scan("T").filter(C.col("a") < C.param(f"c{i}"))
                .compute(**{f"v{i}": C.udf("key_total", C.col("a"))}).project(f"v{i}"))

    return [q(i) for i in range(6)]


def overlap_queue(stmts, per_stmt: int, seed: int = 11):
    """``bench_fused.py:125-133``'s ``_overlap_queue``: round-robin, the
    cutoffs drawn from a pool of 8 values."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 400, 8)
    return [(s, {f"c{i}": int(rng.choice(pool))})
            for _ in range(per_stmt) for i, s in enumerate(stmts)]


def mixed_queue(stmts, per_stmt: int, seed: int = 7):
    """``bench_fused.py:136-146``'s ``_mixed_queue``: round-robin over the
    six statements of :func:`fused_queries`."""
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(per_stmt):
        waves.append((stmts[0], {"cutoff": int(rng.integers(1, 400))}))
        waves.append((stmts[1], {"lo": int(rng.integers(0, 200)),
                                 "scale": float(round(rng.uniform(0.5, 2), 2))}))
        waves.append((stmts[2], {"div": float(round(rng.uniform(1, 4), 2))}))
        waves.append((stmts[3], {"lo": int(rng.integers(0, 100)),
                                 "hi": int(rng.integers(200, 400)),
                                 "off": int(rng.integers(0, 10))}))
        waves.append((stmts[4], None))
        waves.append((stmts[5], {"mod": int(rng.integers(2, 6))}))
    return waves


def mixed_expected(i: int, p: dict | None, a, sums, tol):
    """Statement ``i`` of :func:`fused_queries` under ``p``, in float64 on
    the host: (mask, {column: (values, tolerance)})."""
    a64 = a.astype(np.float64)
    ones = np.ones(len(a), bool)
    if i == 0:
        return a < p["cutoff"], {"v": (sums[a], tol[a])}
    if i == 1:
        w = a64 * np.float32(p["scale"])
        return a >= p["lo"], {"a": (a64, 0.0), "w": (w, 1e-6 * np.abs(w))}
    if i == 2:
        v = sums[a] / np.float32(p["div"])
        return ones, {"v": (v, tol[a] / p["div"] + 1e-6 * np.abs(v))}
    if i == 3:
        return (a > p["lo"]) & (a < p["hi"]), {"z": (a64 + p["off"], 0.0)}
    if i == 4:
        return ones, {"b": (a64 * 2, 0.0)}
    return a % p["mod"] == 0, {"a": (a64, 0.0), "v": (sums[a], tol[a])}


def check_fused_tickets(results, queue, stmts, a, sums, tol, label: str,
                        expected=None) -> None:
    """Every ticket of a :func:`mixed_queue` drain (or another queue, with
    its ``expected``) against its float64 answer: the mask exactly, each
    column within its tolerance."""
    expected = expected or mixed_expected
    for j, (r, (s, p)) in enumerate(zip(results, queue)):
        want_mask, cols = expected(stmts.index(s), p, a, sums, tol)
        m = r.masked
        mask = m.mask.cpu().numpy()
        check(np.array_equal(mask, want_mask), f"{label}[{j}]: mask differs")
        for name, (want, t) in cols.items():
            got = m.table.columns[name].data.cpu().numpy().astype(np.float64)
            err = np.abs(got - want)[mask]
            t = np.broadcast_to(t, want.shape)[mask]
            check(bool((err <= t).all()) and np.isfinite(got[mask]).all(),
                  f"{label}[{j}]: {name} off float64 by {float(err.max(initial=0.0)):.3g}")


def same_results(want, got, label: str) -> None:
    """``bench_fused._check_identical``: masks exactly, every column to
    rtol 1e-5 on the selected rows."""
    for j, (s, b) in enumerate(zip(want, got)):
        m = s.masked.mask.cpu().numpy()
        check(np.array_equal(m, b.masked.mask.cpu().numpy()), f"{label}[{j}]: masks differ")
        for n, c in s.masked.table.columns.items():
            check(np.allclose(b.masked.table.columns[n].data.cpu().numpy()[m],
                              c.data.cpu().numpy()[m], rtol=1e-5),
                  f"{label}[{j}]: {n} differs")


def drain(queue, fuse: bool):
    """``bench_fused._drain_time``'s body: every ticket submitted to a
    ``CoalescingScheduler(max_batch=1024, fuse=fuse)``, one flush, every
    ticket's rows delivered."""
    from repro_torch.serve.scheduler import CoalescingScheduler

    sched = CoalescingScheduler(max_batch=1024, window_s=10.0, fuse=fuse)
    tickets = [sched.submit(s, p) for s, p in queue]
    sched.flush()
    results = [t.result() for t in tickets]
    for r in results:
        r.masked  # deliver every row (both arms slice)
    return results, sched.stats


def drain_arms(queue, rounds: int, timed: bool) -> dict:
    """Both drains of ``queue``, ``rounds`` warm times each in turns (after
    one untimed drain each), with relagg's launches, the peak memory and
    the wall time of each drain."""
    import torch

    from repro_torch.kernels.relagg import ops

    cuda = torch.cuda.is_available() and timed
    out = {}
    for fuse in (False, True):
        drain(queue, fuse)  # the cold drain: plans and programs
    runs = {False: [], True: []}
    for _ in range(rounds):
        for fuse in (False, True):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            ops.LAUNCHES = ops.BATCHED_LAUNCHES = 0
            t0 = time.perf_counter()
            results, stats = drain(queue, fuse)
            wall = time.perf_counter() - t0
            runs[fuse].append({"results": results, "stats": dict(stats), "wall_s": wall,
                               "relagg_launches": ops.LAUNCHES,
                               "relagg_batched_launches": ops.BATCHED_LAUNCHES,
                               "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                                           if cuda else None)})
    for fuse, name in ((False, "perstmt"), (True, "fused")):
        rs = runs[fuse]
        launches = {(r["relagg_launches"], r["relagg_batched_launches"]) for r in rs}
        check(len(launches) == 1, f"{name}: relagg launches vary between drains {launches}")
        st = rs[-1]["results"][0].stats
        out[name] = {"warm_ms": float(np.median([r["wall_s"] * 1e3 for r in rs])),
                     "warm_ms_all": [r["wall_s"] * 1e3 for r in rs],
                     "relagg_launches": rs[-1]["relagg_launches"],
                     "relagg_batched_launches": rs[-1]["relagg_batched_launches"],
                     "peak_gb": rs[-1]["peak_gb"], "batches": rs[-1]["stats"]["batches"],
                     "fused_batches": rs[-1]["stats"]["fused_batches"],
                     "results": rs[-1]["results"]}
        for key in ("fused_programs", "fused_statements", "fused_members", "shared_subtrees",
                    "cse_templates", "cse_template_refs", "cse_shared_nodes", "cse_pool_evals",
                    "cse_bindings", "cse_pool_slots", "dispatch_s", "sync_s", "wave_tickets"):
            if key in st:
                out[name][key] = st[key]
    return out


def fused_dispatch_without_sync(session, queue) -> tuple[list, float]:
    """One warm fused wave of ``queue``: its dispatch
    (``Session._dispatch_fused``) under
    ``torch.cuda.set_sync_debug_mode("error")``, then its wait outside
    it: (results, host ms of the dispatch)."""
    import torch

    from repro_torch.fuse import partition_calls

    calls = [(s, dict(p) if p else {}) for s, p in queue]
    groups, fallbacks = partition_calls(session, calls)
    check(len(groups) == 1 and not fallbacks, f"{len(groups)} fused groups")
    results = [None] * len(calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = session._dispatch_fused(groups[0], results)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_ms = (time.perf_counter() - t0) * 1e3
    session._finalize_fused(rec, results)
    return results, host_ms


def fusion_tables(rows: int, seed: int = 3) -> dict:
    """``tests/conformance_util.py::facts_data`` and ``keys``: ``facts``
    at ``rows`` rows (numpy, ``seed``) and 7 keys."""
    rng = np.random.default_rng(seed)
    return {"facts": dict(fk=rng.integers(0, 7, rows),
                          val=np.round(rng.uniform(-10, 10, rows), 2).astype(np.float32),
                          qty=rng.integers(0, 9, rows)),
            "keys": dict(k=np.arange(7))}


def fusion_oracle_session(rows: int, device=None):
    """The fusion oracle's session (``conformance_util.make_session`` and
    ``FIXED_PROGRAMS["uncorrelated_sum_case"]``'s UDF ``f``) on ``device``."""
    import repro_torch.core as C

    db = C.Session(device=device)
    for name, arrays in fusion_tables(rows).items():
        db.create_table(name, **arrays)
    u = C.UdfBuilder("f", [("p", "float32")], "float32")
    u.declare("v0", "float32", C.param("p") * 1.0)
    u.select({"v0": C.sum_(C.col("val"))}, frm=C.scan("facts"), where=C.col("qty") >= C.lit(4))
    u.set("v0", C.case([(C.var("v0") > C.param("p"), C.var("v0"))], C.lit(0.5)))
    u.return_(C.coalesce(C.var("v0"), C.lit(0.0)))
    db.create_function(u.build())
    return db


def fusion_oracle_queries():
    """``conformance_util.fusion_queries``: the UDF-bearing parameterized
    query, an arithmetic filter over ``facts`` and a parameter-free
    projection of ``keys``."""
    import repro_torch.core as C

    col, param = C.col, C.param
    return [
        C.scan("keys").filter(col("k") < param("cut"))
         .compute(out=C.udf("f", col("k") * 1.0 + param("shift"))).project("k", "out"),
        C.scan("facts").filter(col("qty") >= param("minq"))
         .compute(w=col("val") * param("scale")).project("fk", "w"),
        C.scan("keys").compute(z=col("k") * 2.0).project("k", "z"),
    ]


#: ``conformance_util.fusion_calls_spec``: [(statement index, params)]
FUSION_CALLS = [(0, {"cut": 5, "shift": 0.5}), (1, {"minq": 4, "scale": 2.0}), (2, None),
                (0, {"cut": 3, "shift": 1.5}), (1, {"minq": 1, "scale": 0.5}),
                (0, {"cut": 6.5, "shift": 2.0}), (2, {})]


def fusion_oracle_run(rows: int, policy_name: str, device=None):
    """The oracle's queue through a fusion-mode scheduler and the serial
    loop: (fused results, serial results, the first fused stats)."""
    import repro_torch.core as C
    from repro_torch.serve.scheduler import CoalescingScheduler

    db = fusion_oracle_session(rows, device)
    stmts = [db.prepare(q, getattr(C, policy_name)) for q in fusion_oracle_queries()]
    sched = CoalescingScheduler(max_batch=256, window_s=10.0, fuse=True)
    tickets = [sched.submit(stmts[i], p) for i, p in FUSION_CALLS]
    sched.flush()
    fused = [t.result() for t in tickets]
    serial = [stmts[i].execute(params=p) for i, p in FUSION_CALLS]
    st = next(r.stats for r in fused if r.stats.get("fused"))
    return fused, serial, st


def same_masked(want, got, label: str, rtol: float = 2e-3, atol: float = 1e-3) -> None:
    """``conformance_util.assert_rows_equal`` on two results of either
    device: masks and surviving validity exactly, values within tolerance."""
    wm, gm = want.masked, got.masked
    em, hm = wm.mask.cpu().numpy(), gm.mask.cpu().numpy()
    check(np.array_equal(em, hm), f"{label}: mask")
    check(sorted(wm.table.columns) == sorted(gm.table.columns), f"{label}: schema")
    for n, c in wm.table.columns.items():
        g = gm.table.columns[n]
        ev, gv = c.validity().cpu().numpy(), g.validity().cpu().numpy()
        check(np.array_equal(ev[em], gv[em]), f"{label}: validity({n})")
        live = em & ev & gv
        check(np.allclose(c.data.cpu().numpy().astype(np.float64)[live],
                          g.data.cpu().numpy().astype(np.float64)[live], rtol=rtol, atol=atol),
              f"{label}: values({n})")


def fused_mixed(device, detail_rows: int, per_stmt: int, rounds: int, timed: bool) -> dict:
    """(a) and (b) on a ``key_total`` session of ``detail_rows`` rows on
    ``device``: the mixed queue (``per_stmt`` tickets a statement) and the
    overlap queue, each drained per statement and fused; every ticket of
    the mixed queue against float64, the first ``FUSED_SERIAL_N`` against
    the serial loop; relagg's launches per drain."""
    import repro_torch.core as C

    db, a, sums, tol = invocation_session(detail_rows, device)
    policy = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    out: dict = {"detail_rows": detail_rows, "T_rows": len(a), "per_stmt": per_stmt}
    for name, build, make_queue in (("mixed", fused_queries, mixed_queue),
                                    ("overlap", overlap_queries, overlap_queue)):
        stmts = [db.prepare(q, policy) for q in build()]
        queue = make_queue(stmts, per_stmt)
        arms = drain_arms(queue, rounds, timed)
        serial = [s.execute(params=p) for s, p in queue[:FUSED_SERIAL_N]]
        for arm_name in ("perstmt", "fused"):
            results = arms[arm_name].pop("results")
            same_results(serial, results[:FUSED_SERIAL_N], f"{name} {arm_name} vs serial")
            if name == "mixed":
                check_fused_tickets(results, queue, stmts, a, sums, tol,
                                    f"{name} {arm_name} vs float64")
        if name == "mixed":
            check_fused_tickets(serial, queue, stmts, a, sums, tol, "mixed serial vs float64")
        fused, per = arms["fused"], arms["perstmt"]
        n_udf = 3 if name == "mixed" else 6  # statements calling key_total
        check(fused["fused_batches"] == 1 and fused["batches"] == 1
              and per["fused_batches"] == 0 and per["batches"] == len(stmts),
              f"{name}: drains {fused['batches']} fused, {per['batches']} per statement")
        check(fused["relagg_launches"] == 1 and per["relagg_launches"] == n_udf
              and fused["relagg_batched_launches"] == per["relagg_batched_launches"] == 0,
              f"{name}: relagg launches a drain, fused {fused['relagg_launches']}, per statement "
              f"{per['relagg_launches']} (batched {fused['relagg_batched_launches']}, "
              f"{per['relagg_batched_launches']})")
        check(fused["fused_statements"] == 6 and fused["shared_subtrees"] >= 1,
              f"{name}: {fused}")
        out[name] = arms
    ov = out["overlap"]["fused"]
    check(ov["cse_bindings"] == OVERLAP_BINDINGS and ov["cse_pool_evals"] == OVERLAP_POOL_EVALS,
          f"overlap: cse_bindings {ov['cse_bindings']}, cse_pool_evals {ov['cse_pool_evals']}")
    if timed:
        stmts = [db.prepare(q, policy) for q in fused_queries()]
        queue = mixed_queue(stmts, per_stmt)
        results, host_ms = fused_dispatch_without_sync(db, queue)
        check_fused_tickets(results, queue, stmts, a, sums, tol, "fused wave under the sync check")
        out["sync_check_host_ms"] = host_ms
    del db
    return out


def fused_phase() -> dict:
    """Multi-statement fusion on the card: (a) the mixed queue and (b) the
    overlap queue of ``benchmarks/bench_fused.py`` over the invocation
    phase's tables (``detail`` at 6,000,000 rows, relagg on), drained per
    statement and fused, 64 tickets a statement, 5 warm drains an arm;
    (c) the fusion oracle's queue over 20,000 ``facts`` rows under FROID
    and HEKATON, fused == serial == the same on the CPU; (d) admission's
    ``evaluate_coalesced`` with ``fuse=True`` against ``evaluate``."""
    import torch

    from repro_torch.configs import config_for
    from repro_torch.serve.admission import AdmissionPolicy

    t0 = time.perf_counter()
    out = fused_mixed(None, INVOCATION_ROWS["detail"], FUSED_PER_STMT, FUSED_DRAINS, timed=True)
    for name in ("mixed", "overlap"):
        f, p = out[name]["fused"], out[name]["perstmt"]
        log(f"fused ({'a' if name == 'mixed' else 'b'}) {name} queue, {6 * FUSED_PER_STMT} "
            f"tickets: warm ms a drain per statement {p['warm_ms']:.2f} ({p['batches']} drains, "
            f"relagg {p['relagg_launches']}), fused {f['warm_ms']:.2f} (1 wave: "
            f"{f['fused_members']} members, shared_subtrees {f['shared_subtrees']}, "
            f"cse_templates {f['cse_templates']}, cse_bindings {f['cse_bindings']}, "
            f"cse_pool_evals {f['cse_pool_evals']}, dispatch {f['dispatch_s'] * 1e3:.2f} ms, "
            f"sync {f['sync_s'] * 1e3:.2f} ms, relagg {f['relagg_launches']}); peak GB "
            f"{p['peak_gb']:.3f} / {f['peak_gb']:.3f}; == serial (first {FUSED_SERIAL_N})"
            + (" == float64" if name == "mixed" else ""))
    log(f"fused (a) one warm wave dispatched with no host sync in "
        f"{out['sync_check_host_ms']:.2f} ms")
    gc.collect()
    torch.cuda.empty_cache()
    out["oracle"] = {}
    for policy in ("FROID", "HEKATON"):
        fused, serial, st = fusion_oracle_run(FUSION_FACTS_ROWS, policy)
        cpu_fused, _, cpu_st = fusion_oracle_run(FUSION_FACTS_ROWS, policy, "cpu")
        for j, (s, f, c) in enumerate(zip(serial, fused, cpu_fused)):
            same_masked(s, f, f"(c) {policy} fused[{j}] vs serial")
            same_masked(c, f, f"(c) {policy} fused[{j}] card vs CPU")
        keys = ("fused_programs", "fused_statements", "fused_members", "shared_subtrees",
                "cse_templates", "cse_pool_evals")
        check(all(st[k] == cpu_st[k] for k in keys) and st["fused_programs"] < st["fused_statements"],
              f"(c) {policy}: card {st} vs CPU {cpu_st}")
        out["oracle"][policy] = {k: st[k] for k in keys}
        log(f"fused (c) fusion oracle {policy}, {FUSION_FACTS_ROWS} facts rows: fused == serial "
            f"== CPU; {out['oracle'][policy]}")
    reqs = serve_requests(config_for("granite3_2b").vocab)
    fields = {"tier": np.array([r.tier for r in reqs]),
              "prompt_len": np.array([len(r.prompt) for r in reqs]),
              "max_new_tokens": np.array([r.max_new_tokens for r in reqs]),
              "temperature": np.array([r.temperature for r in reqs])}
    ap = AdmissionPolicy(fuse=True)
    check(ap.scheduler.fuse, "admission: fuse did not reach the scheduler")
    tick, co = ap.evaluate(fields), ap.evaluate_coalesced(fields)
    check(all(np.array_equal(tick[k], co[k]) for k in ("admit", "granted"))
          and np.allclose(tick["temp"], co["temp"], rtol=1e-6),
          f"(d) admission fuse=True: coalesced {co} vs tick {tick}")
    log(f"fused (d) AdmissionPolicy(fuse=True): evaluate_coalesced == evaluate "
        f"({len(reqs)} requests)")
    out["seconds"] = time.perf_counter() - t0
    log(f"fused phase ok in {out['seconds']:.1f} s")
    return out


#: the routed phase: waves a queue is drained under ``ROUTED`` (the first
#: two explore the fused and the per-statement arm, the rest are measured),
#: ``benchmarks/bench_cost_routing.py``'s tickets a statement, its overhead
#: row's k, the bucket axis's N, and the routing oracle's waves
ROUTED_WAVES = 6
ROUTING_PER_STMT = 48
ROUTING_MANY_K = 128
BUCKET_N = (1024, 100)
ROUTING_ORACLE_WAVES = 3
#: (c)'s interleaved pairs of warm calls
ROUTED_REPEATS = 15


def routing_queries():
    """``benchmarks/bench_cost_routing.py:76-86``'s ``_queries``: the
    ``key_total`` statement and two arithmetic filters over ``T`` —
    :func:`fused_queries`' statements 0, 1 and 3."""
    qs = fused_queries()
    return [qs[0], qs[1], qs[3]]


def routing_queue(stmts, per_stmt: int, seed: int = 7):
    """``bench_cost_routing.py:89-101``'s ``_queue``: round-robin over the
    three statements of :func:`routing_queries`."""
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(per_stmt):
        waves.append((stmts[0], {"cutoff": int(rng.integers(1, 400))}))
        waves.append((stmts[1], {"lo": int(rng.integers(0, 200)),
                                 "scale": float(round(rng.uniform(0.5, 2), 2))}))
        waves.append((stmts[2], {"lo": int(rng.integers(0, 100)),
                                 "hi": int(rng.integers(200, 400)),
                                 "off": int(rng.integers(0, 10))}))
    return waves


def routing_expected(i: int, p: dict, a, sums, tol):
    """Statement ``i`` of :func:`routing_queries` in float64 on the host."""
    return mixed_expected((0, 1, 3)[i], p, a, sums, tol)


def overlap_expected(i: int, p: dict, a, sums, tol):
    """Statement ``i`` of :func:`overlap_queries` in float64 on the host."""
    return a < p[f"c{i}"], {f"v{i}": (sums[a], tol[a])}


def routed_policies():
    """(static FROID, ROUTED), both with relagg on: one fingerprint, so
    they share plans, executables and the router's cost keys, as the
    benchmark's statements do on its one session."""
    import dataclasses

    import repro_torch.core as C

    return (C.ExecutionPolicy(name="froid+relagg", pallas_agg=True),
            dataclasses.replace(C.ROUTED, name="routed+relagg", pallas_agg=True))


def fuse_rule_holds(decisions) -> bool:
    """Every measured fuse decision is the arm the router's own EMAs (the
    ``fused_s`` and ``unfused_s`` it logged) favour under ``FUSE_MARGIN``,
    given its previous measured choice for that wave (sticky)."""
    from repro_torch.cost.router import FUSE_MARGIN

    last: dict = {}
    for d in decisions:
        if d["axis"] != "fuse" or d["why"] != "measured":
            continue
        f, u, prev = d["fused_s"], d["unfused_s"], last.get(d["wave"])
        if prev is None:
            want = f <= u
        elif prev:
            want = not (u < f * FUSE_MARGIN)
        else:
            want = f < u * FUSE_MARGIN
        if d["choice"] != want:
            return False
        last[d["wave"]] = d["choice"]
    return True


def new_decisions(router, before: int) -> list:
    """The decisions ``router`` logged since its counter read ``before``."""
    n = router.stats["decisions"] - before
    return list(router.decisions)[-n:] if n else []


def static_queue(db, name: str, build, make_queue, expected, per_stmt: int, a, sums,
                 tol) -> dict:
    """A queue's static FROID statements (relagg on), its serial loop
    against float64, and both static drains once (the cold drains: plans
    and programs).  Run before the session's first ``ROUTED`` prepare, as
    ``bench_cost_routing.py`` warms its static arms, so that no router
    learns from the cold drains."""
    static, _ = routed_policies()
    stmts = [db.prepare(q, static) for q in build()]
    queue = make_queue(stmts, per_stmt)
    serial = [s.execute(params=p) for s, p in queue]
    check_fused_tickets(serial, queue, stmts, a, sums, tol, f"{name} serial vs float64",
                        expected)
    for fuse in (True, False):
        drain(queue, fuse)
    return {"name": name, "build": build, "expected": expected, "stmts": stmts,
            "queue": queue, "serial": serial}


def routed_queue(db, sq: dict, a, sums, tol, waves: int, timed: bool) -> dict:
    """(a) or (b): the queue of :func:`static_queue` under ``ROUTED``
    drained ``waves`` times through ``CoalescingScheduler(max_batch=1024,
    fuse=True)``, the router picking the arm each wave, and the two static
    FROID arms (``fuse=True``, ``fuse=False``) drained in turns with its
    measured waves, as ``bench_cost_routing.py``'s ``_static_time`` rounds
    are.  Every ticket of every drain == the static FROID serial loop ==
    float64; relagg's launches a drain by arm."""
    from repro_torch.kernels.relagg import ops

    _, routed = routed_policies()
    name, expected, serial = sq["name"], sq["expected"], sq["serial"]
    s_stmts, queue = sq["stmts"], sq["queue"]
    r_stmts = [db.prepare(q, routed) for q in sq["build"]()]
    r_queue = [(r_stmts[s_stmts.index(s)], p) for s, p in queue]
    router = db.cost_router

    def timed_drain(q, fuse: bool, label: str) -> tuple[float, list, int]:
        ops.LAUNCHES = ops.BATCHED_LAUNCHES = 0
        t0 = time.perf_counter()
        results, _ = drain(q, fuse)
        wall = time.perf_counter() - t0
        same_results(serial, results, f"{name} {label} vs serial")
        check_fused_tickets(results, queue, s_stmts, a, sums, tol,
                            f"{name} {label} vs float64", expected)
        return wall, results, ops.LAUNCHES

    rows: list[dict] = []
    launches: dict = {}

    def routed_wave() -> float:
        before = router.stats["decisions"]
        wall, results, n = timed_drain(r_queue, True, f"routed wave {len(rows)}")
        logged = new_decisions(router, before)
        fuse = [d for d in logged if d["axis"] == "fuse"]
        check(len(fuse) == 1, f"{name}: {len(fuse)} fuse decisions in one routed wave")
        d = fuse[0]
        arm = "fused" if d["choice"] else "perstmt"
        check(results[0].stats.get("fused", False) == d["choice"],
              f"{name}: the wave ran {results[0].stats.get('fused')} against choice {d}")
        # the policy each ticket ran under: the router may send a statement
        # of a per-statement drain to HEKATON (the policy axis), whose
        # per-row interpreter launches no relagg
        policies = sorted({r.policy.name for r in results})
        key = f"{arm}/{'+'.join(policies)}"
        check(launches.setdefault(key, n) == n,
              f"{name}: relagg launches a {key} drain vary ({launches[key]}, {n})")
        rows.append({"choice": d["choice"], "why": d["why"], "wall_ms": wall * 1e3,
                     "policies": policies, "relagg_launches": n,
                     "policy_decisions": [(p["choice"], p["why"]) for p in logged
                                          if p["axis"] == "policy"],
                     "fused_s": d.get("fused_s"), "unfused_s": d.get("unfused_s")})
        if timed:
            log(f"routed ({'a' if name == 'routing' else 'b'}) {name} wave {len(rows)}: "
                f"{arm} ({d['why']}) under {', '.join(policies)}, {wall * 1e3:.2f} ms, "
                f"relagg {n}"
                + (f"; EMAs fused {d['fused_s'] * 1e3:.2f} ms, per statement "
                   f"{d['unfused_s'] * 1e3:.2f} ms" if d["why"] == "measured" else "")
                + "".join(f"; policy -> {c} ({w})" for c, w in rows[-1]["policy_decisions"]))
        return wall

    routed_wave()  # explores the fused arm
    routed_wave()  # explores the per-statement arm
    ts_f, ts_u, ts_r = [], [], []
    for _ in range(waves - 2):
        ts_f.append(timed_drain(queue, True, "static fused")[0])
        ts_u.append(timed_drain(queue, False, "static per statement")[0])
        ts_r.append(routed_wave())
    whys = [r["why"] for r in rows]
    check(whys[:2] == ["explore-fused", "explore-unfused"]
          and all(w == "measured" for w in whys[2:]), f"{name}: decisions {whys}")
    check(fuse_rule_holds(router.decisions), f"{name}: a measured fuse choice is not the "
          f"one the EMAs favour under FUSE_MARGIN: {list(router.decisions)}")
    out = {"tickets": len(queue), "waves": rows, "settled": rows[-1]["choice"],
           "relagg_launches": launches,
           "static_fused_ms": [t * 1e3 for t in ts_f],
           "static_perstmt_ms": [t * 1e3 for t in ts_u],
           "routed_ms": [t * 1e3 for t in ts_r],
           "routed_vs_best": float(np.median([r / min(f, u) for f, u, r
                                              in zip(ts_f, ts_u, ts_r)])),
           "routed_vs_worst": float(np.median([r / max(f, u) for f, u, r
                                               in zip(ts_f, ts_u, ts_r)]))}
    if timed:
        log(f"routed ({'a' if name == 'routing' else 'b'}) {name} queue, {len(queue)} tickets: "
            f"settles on {'fused' if out['settled'] else 'per statement'}; ms a drain static "
            f"fused {np.median(ts_f) * 1e3:.2f}, static per statement "
            f"{np.median(ts_u) * 1e3:.2f}, routed {np.median(ts_r) * 1e3:.2f}; routed_vs_best "
            f"{out['routed_vs_best']:.4f}, routed_vs_worst {out['routed_vs_worst']:.4f}; "
            f"every ticket == static FROID serial == float64")
    return out


def bucket_axis(db, a, sums, tol, timed: bool) -> dict:
    """(d): ``key_total``'s ``execute_many`` under ``ROUTED`` at N = 1,024
    (cold, then warm), then at N = 100, whose natural bucket (128) is cold:
    the router rides the warm 1,024 or pays the cold 128.  Both arms'
    ms, in turns where both are warm, and the cold bucket's real cost
    beside the model's ``estimate_compile_s``."""
    import repro_torch.core as C
    from repro_torch.core import relalg as R
    from repro_torch.cost import estimate_compile_s

    static, routed = routed_policies()
    r_stmt = db.prepare(key_total_query(), routed)
    s_stmt = db.prepare(key_total_query(), static)
    router = db.cost_router
    rng = np.random.default_rng(17)
    big, small = (rng.integers(1, INVOCATION_ROWS["keys"], n) for n in BUCKET_N)
    big_p, small_p = ([{"cutoff": int(c)} for c in x] for x in (big, small))
    for _ in range(5):  # cold, then warm: the bucket's wave EMA settles
        got = r_stmt.execute_many(big_p)
    check_key_totals(got, big, a, sums, tol, "(d) N=1024")
    natural = C.batch_bucket(BUCKET_N[1], 1024)

    def routed_call() -> tuple[dict, int, list]:
        """One routed N = 100 call: (its arm, the bucket it ran in, the
        bucket decisions it logged) — a ride is logged, the natural bucket
        is not."""
        before = router.stats["decisions"]
        r = arm(lambda: r_stmt.execute_many(small_p))
        check_key_totals(r["out"], small, a, sums, tol, "(d) routed N=100")
        b = r["out"][0].stats["batch_bucket"]
        logged = [d for d in new_decisions(router, before) if d["axis"] == "bucket"]
        check(b in (natural, BUCKET_N[0]) and (b == BUCKET_N[0]) == bool(logged)
              and all(d["warm_wave_s"] < d["cold_est_s"] for d in logged),
              f"(d) routed N=100 ran in bucket {b}, decisions {logged}")
        return r, b, logged

    ride, bucket, log_b = routed_call()
    routed_ms: dict = {}
    for _ in range(3):  # the same choice while the natural bucket stays cold
        r, b, _ = routed_call()
        routed_ms.setdefault(b, []).append(r["wall_s"] * 1e3)
    # the natural arm: the static statement's bucket 128, cold then warm
    cold = arm(lambda: s_stmt.execute_many(small_p))
    check(cold["out"][0].stats["batch_bucket"] == natural, "(d) static N=100 bucket")
    check_key_totals(cold["out"], small, a, sums, tol, "(d) static N=100")
    natural_ms = [arm(lambda: s_stmt.execute_many(small_p))["wall_s"] * 1e3 for _ in range(3)]
    plan = s_stmt.plan
    out = {"natural": natural, "bucket": bucket, "rode": bucket != natural,
           "decision": log_b[0] if log_b else None,
           "routed_ms": {int(b): v for b, v in routed_ms.items()},
           "routed_first_ms": ride["wall_s"] * 1e3,
           "natural_cold_ms": cold["wall_s"] * 1e3, "natural_warm_ms": natural_ms,
           "cold_bucket_ms": cold["wall_s"] * 1e3 - float(np.median(natural_ms)),
           "estimate_compile_ms": estimate_compile_s(plan) * 1e3,
           "plan_nodes": R.plan_size(plan)}
    if timed:
        d = out["decision"]
        log(f"routed (d) bucket axis, key_total N=100 (natural bucket {natural}): the router "
            f"{'rides ' + str(bucket) if out['rode'] else 'keeps ' + str(natural)}"
            + (f" (warm wave {d['warm_wave_s'] * 1e3:.2f} ms < cold estimate "
               f"{d['cold_est_s'] * 1e3:.2f} ms)" if d else "")
            + "; ms routed " + ", ".join(f"in {b} {np.median(v):.2f}" for b, v in routed_ms.items())
            + f" (first {out['routed_first_ms']:.2f}), "
            f"bucket {natural} warm {np.median(natural_ms):.2f}, cold "
            f"{out['natural_cold_ms']:.2f}: a cold bucket costs {out['cold_bucket_ms']:.2f} ms "
            f"on the card against the model's {out['estimate_compile_ms']:.1f} "
            f"(COMPILE_S_PER_NODE x {out['plan_nodes']} nodes)")
    return out


def routing_overhead(db, timed: bool) -> dict:
    """(c): ``bench_cost_routing.py``'s overhead row on ``key_total``:
    ``execute_many`` of k = 128 cache-resident tickets under static FROID
    and under ``ROUTED``, in interleaved pairs; the median ratio
    (routed / static) and each arm's best ms.  The results are equal
    bit for bit."""
    static, routed = routed_policies()
    s_stmt = db.prepare(key_total_query(), static)
    r_stmt = db.prepare(key_total_query(), routed)
    rng = np.random.default_rng(19)
    params = [{"cutoff": int(c)} for c in rng.integers(1, INVOCATION_ROWS["keys"],
                                                         ROUTING_MANY_K)]
    s_stmt.execute_many(params)
    r_stmt.execute_many(params)
    ts_s, ts_r = [], []
    for _ in range(ROUTED_REPEATS):
        t0 = time.perf_counter()
        rs_s = s_stmt.execute_many(params)
        ts_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rs_r = r_stmt.execute_many(params)
        ts_r.append(time.perf_counter() - t0)
    same_tickets(rs_s, rs_r, "v", "(c) ROUTED vs FROID execute_many", exact=True)
    out = {"k": ROUTING_MANY_K, "static_ms": min(ts_s) * 1e3, "routed_ms": min(ts_r) * 1e3,
           "overhead": float(np.median([r / s for s, r in zip(ts_s, ts_r)]))}
    if timed:
        log(f"routed (c) overhead, key_total execute_many k={ROUTING_MANY_K} cache-resident: "
            f"static {out['static_ms']:.3f} ms, routed {out['routed_ms']:.3f} ms (best of "
            f"{ROUTED_REPEATS}); overhead {out['overhead']:.4f} (median of the pairs' ratios)")
    return out


def routed_sync_check(db, a, sums, tol) -> float:
    """One routed ``execute_many`` dispatch (the policy choice, the bucket
    choice, the stacking and the launch) under
    ``torch.cuda.set_sync_debug_mode("error")``; its wait and the
    router's sample outside it.  Returns the host ms of the dispatch."""
    import torch

    from repro_torch.core.session import param_signature

    _, routed = routed_policies()
    stmt = db.prepare(key_total_query(), routed)
    cutoffs = np.random.default_rng(23).integers(1, INVOCATION_ROWS["keys"], 32)
    plist = [{"cutoff": int(c)} for c in cutoffs]
    stmt.execute_many(plist)
    env = db._env_token()
    pending: list = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        target = stmt._route_target()
        target._dispatch_batch(list(range(len(plist))), plist, param_signature(plist[0]),
                               env, pending, target.policy.max_batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_ms = (time.perf_counter() - t0) * 1e3
    check(len(pending) == 1, f"{len(pending)} chunks for {len(plist)} tickets")
    samples = db.cost_router.stats["samples"]
    results = [None] * len(plist)
    target._finalize_batch(pending[0], results, 1)
    check(db.cost_router.stats["samples"] == samples + 1, "the routed chunk was not sampled")
    check_key_totals(results, cutoffs, a, sums, tol, "routed execute_many under the sync check")
    return host_ms


def routing_oracle_run(rows: int, fuse: bool, device=None):
    """``conformance_util.check_routing_oracle`` (unsharded) on ``device``:
    the fusion oracle's queue (:data:`FUSION_CALLS`) under ``ROUTED``
    through a scheduler in ``fuse`` drain mode, ``ROUTING_ORACLE_WAVES``
    waves, then a serial pass, each ticket against the FROID serial loop
    of a second session.  Returns (the last wave's results, the serial
    oracle's, ``cost_stats``)."""
    import repro_torch.core as C
    from repro_torch.serve.scheduler import CoalescingScheduler

    oracle = fusion_oracle_session(rows, device)
    o_stmts = [oracle.prepare(q, C.FROID) for q in fusion_oracle_queries()]
    expected = [o_stmts[i].execute(params=p) for i, p in FUSION_CALLS]
    db = fusion_oracle_session(rows, device)
    stmts = [db.prepare(q, C.ROUTED) for q in fusion_oracle_queries()]
    sched = CoalescingScheduler(max_batch=256, window_s=10.0, fuse=fuse)
    for w in range(ROUTING_ORACLE_WAVES):
        tickets = [sched.submit(stmts[i], p) for i, p in FUSION_CALLS]
        sched.flush()
        results = [t.result() for t in tickets]
        for j, r in enumerate(results):
            same_masked(expected[j], r, f"(f) fuse={fuse} wave {w}[{j}] vs FROID serial")
    for j, (i, p) in enumerate(FUSION_CALLS):
        same_masked(expected[j], stmts[i].execute(params=p), f"(f) fuse={fuse} serial[{j}]")
    cs = db.cost_stats
    check(cs["enabled"] and cs["samples"] >= 1, f"(f) fuse={fuse}: router {cs}")
    return results, expected, cs


def routed_run(device, detail_rows: int, per_stmt: tuple[int, int], waves: int,
               timed: bool) -> dict:
    """(a)-(d) on a fresh ``key_total`` session of ``detail_rows`` rows on
    ``device``: (a) the routing queue and (b) the overlap queue
    (``per_stmt`` tickets a statement in each) under
    ``ROUTED``, then (d) the bucket axis (before (c), whose k = 128 warms
    the bucket (d) needs cold), (c) the overhead and, on the card, one
    routed dispatch under the sync check."""
    db, a, sums, tol = invocation_session(detail_rows, device)
    out = {"detail_rows": detail_rows}
    queues = [static_queue(db, "routing", routing_queries, routing_queue, routing_expected,
                           per_stmt[0], a, sums, tol),
              static_queue(db, "overlap", overlap_queries, overlap_queue, overlap_expected,
                           per_stmt[1], a, sums, tol)]
    check(db.cost_router is None, "a router before the first ROUTED prepare")
    for sq in queues:
        out[sq["name"]] = routed_queue(db, sq, a, sums, tol, waves, timed)
    out["bucket"] = bucket_axis(db, a, sums, tol, timed)
    out["overhead"] = routing_overhead(db, timed)
    if timed:
        out["sync_check_host_ms"] = routed_sync_check(db, a, sums, tol)
        log(f"routed one execute_many dispatch (policy and bucket chosen, 32 tickets) with no "
            f"host sync in {out['sync_check_host_ms']:.2f} ms; sampled after its wait")
    cs = db.cost_stats
    check(cs["samples"] >= 1, f"router: {cs}")
    out["cost_stats"] = {k: cs[k] for k in ("samples", "samples_excluded", "decisions",
                                            "policy_reroutes", "bucket_rides",
                                            "waves_fused", "waves_unfused")}
    del db
    return out


def routed_policy_axis(full) -> dict:
    """(e), on the SF-1 session: Q6 and Q12 in their UDF form under
    ``ROUTED`` (relagg on).  The router's verdict is asked first (the
    choice ``execute`` makes), from its estimates of the FROID and HEKATON
    candidates.  A verdict that keeps FROID runs serially, cold then warm,
    and equals FROID unrouted; a verdict that explores HEKATON is recorded
    and not run at SF 1, where the per-row interpreter over 6,000,000
    ``lineitem`` rows takes hours (PERF.md §5, the cut cells): the check is
    then that the verdict is the one the estimates give under
    ``EXPLORE_MARGIN``."""
    from repro_torch.cost.router import EXPLORE_MARGIN
    from repro_torch.data.tpch_udfs import QUERIES

    static, routed = routed_policies()
    out = {}
    for name in ("Q6", "Q12"):
        stmt = full.prepare(QUERIES[name][0](), routed)
        router = full.cost_router
        before = router.stats["decisions"]
        verdict = router.choose_policy(stmt)
        ests = {c.name: router.estimate_policy_s(stmt, c)
                for c, _ in router._policy_candidates(stmt)}
        log_p = [d for d in new_decisions(router, before) if d["axis"] == "policy"]
        inc = ests[routed.name]
        best = min(ests, key=ests.get)
        want = best if ests[best] < inc * EXPLORE_MARGIN else routed.name
        check(verdict.name == want, f"(e) {name}: verdict {verdict.name}, estimates {ests}")
        row = {"verdict": verdict.name, "why": log_p[0]["why"] if log_p else "incumbent",
               "estimates_ms": {k: v * 1e3 for k, v in ests.items()}, "ran": False}
        if verdict.fingerprint() == stmt.policy.fingerprint():
            s_stmt = full.prepare(QUERIES[name][0](), static)
            want_t = s_stmt.execute().table
            cold = stmt.execute()
            warm, s_warm = [], []
            for order in ((stmt, s_stmt), (s_stmt, stmt)) * (WARM_ROUNDS // 2):  # in turns
                for st in order:
                    r = st.execute()
                    (warm if st is stmt else s_warm).append(r)
            for label, r in (("cold", cold), ("warm", warm[-1])):
                compare_tables(want_t, r.table, f"(e) {name} ROUTED {label} vs FROID", 1e-5, 1e-5)
                if full.device.type == "cuda":
                    check_on_card(r, f"(e) {name}")
            row.update(ran=True, warm_ms=float(np.median([r.elapsed_s * 1e3 for r in warm])),
                       froid_warm_ms=float(np.median([r.elapsed_s * 1e3 for r in s_warm])))
        out[name] = row
        log(f"routed (e) {name} UDF form at SF 1: verdict {row['verdict']} ({row['why']}; "
            f"estimates " + ", ".join(f"{k} {v:.4f} ms" for k, v in row["estimates_ms"].items())
            + ("); == FROID unrouted, warm ms routed "
               f"{row['warm_ms']:.2f}, FROID {row['froid_warm_ms']:.2f}" if row["ran"] else
               "); HEKATON over 6,000,000 rows not run"))
    return out


def routed_phase(policy_axis: dict) -> dict:
    """Cost routing on the card (``ROUTED``, ``Session.cost_stats``): (a)
    ``bench_cost_routing.py``'s queue (3 statements x 48 tickets) and (b)
    ``bench_fused.py``'s overlap queue (6 x 64) over the invocation
    phase's tables (``detail`` 6,000,000 rows, relagg on), 6 routed waves
    each beside the static FROID arms; (c) the overhead of routing
    ``execute_many``; (d) the bucket axis; (e) (run earlier, on the SF-1
    session, passed in) the policy axis; (f) the routing oracle at 20,000
    ``facts`` rows, fused and not, card == CPU == FROID serial."""
    t0 = time.perf_counter()
    out = routed_run(None, INVOCATION_ROWS["detail"], (ROUTING_PER_STMT, FUSED_PER_STMT),
                     ROUTED_WAVES, timed=True)
    out["policy"] = policy_axis
    gc.collect()
    out["oracle"] = {}
    for fuse in (True, False):
        card, _, cs = routing_oracle_run(FUSION_FACTS_ROWS, fuse)
        cpu, _, _ = routing_oracle_run(FUSION_FACTS_ROWS, fuse, "cpu")
        for j, (c, g) in enumerate(zip(cpu, card)):
            same_masked(c, g, f"(f) fuse={fuse}[{j}] card vs CPU")
        out["oracle"][f"fuse={fuse}"] = {k: cs[k] for k in ("samples", "waves_fused",
                                                            "waves_unfused", "decisions")}
        log(f"routed (f) routing oracle fuse={fuse}, {FUSION_FACTS_ROWS} facts rows, "
            f"{ROUTING_ORACLE_WAVES} waves: card == CPU == FROID serial; "
            f"{out['oracle'][f'fuse={fuse}']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"routed phase ok in {out['seconds']:.1f} s; router {out['cost_stats']}")
    return out


# ---------------------------------------------------------------------------
# fleet phase: the persistent plan store, cost tables and the fleet
# ---------------------------------------------------------------------------

#: ``benchmarks/bench_fleet.py``'s population and trace, ``T`` at the
#: invocation phase's real ``detail`` scale
FLEET_STATEMENTS = 12
FLEET_TRACE_K = 96
FLEET_T_ROWS = 6_000_000
FLEET_TIMED_DRAINS = 3
#: drains the first routed fleet may take to measure both fuse arms
FLEET_MEASURE_DRAINS = 6
#: drains of the routed fleets set side by side
FLEET_ROUTED_SHOWN = 3
FLEET_ADMISSION_REQUESTS = 64
#: relagg launches from each of two host threads, and their shapes
RELAGG_THREAD_CALLS = 40
RELAGG_THREAD_SHAPES = ((100_000, 7, 4), (100_000, 25, 2), (100_000, 130, 4),
                        (100_000, 150_000, 2))
#: calls each of two threads makes at once on the global path's shape (the
#: last of ``RELAGG_THREAD_SHAPES``), with the launch lock and without it
RELAGG_THREAD_GLOBAL_CALLS = 400


def address_free(text: str) -> str:
    """Explain text with object addresses left out."""
    return re.sub(r" object at 0x[0-9a-f]+", "", text)


def bit_equal_tables(a, b, label: str) -> None:
    """Rows equal in order, every column's validity and valid bytes."""
    check(a.names() == b.names() and a.num_rows == b.num_rows,
          f"{label}: {a.names()} x {a.num_rows} vs {b.names()} x {b.num_rows}")
    for name in a.names():
        ca, cb = a.columns[name], b.columns[name]
        va, vb = ca.validity().cpu().numpy(), cb.validity().cpu().numpy()
        xa, xb = ca.data.cpu().numpy(), cb.data.cpu().numpy()
        check(np.array_equal(va, vb) and xa.dtype == xb.dtype
              and xa[va].tobytes() == xb[vb].tobytes(), f"{label}: {name} not bit-equal")


def fleet_tpch_session(store, sf: float, device=None):
    """A fresh session over ``store`` holding TPC-H at ``sf`` (seed 0, as
    each worker generates it) and the UDFs of its queries."""
    import repro_torch.core as C
    from repro_torch.data.tpch import generate_tpch
    from repro_torch.data.tpch_udfs import register_udfs

    session = C.Session(device=device, store=store)
    generate_tpch(session, sf=sf)
    register_udfs(session)
    return session


def first_call(session, query, policy) -> dict:
    """``prepare`` and the first ``execute`` of ``query`` on the host clock
    (the execute ends waiting for the device), with relagg's launches and
    the store counters it moved."""
    from repro_torch.kernels.relagg import ops

    keys = ("persist_hits", "persist_misses", "persist_rejects")
    before = {k: session.cache_stats[k] for k in keys}
    ops.LAUNCHES = 0  # counts this call only
    t0 = time.perf_counter()
    stmt = session.prepare(query, policy)
    result = stmt.execute()
    ms = (time.perf_counter() - t0) * 1e3
    return {"stmt": stmt, "result": result, "ms": ms, "relagg_launches": ops.LAUNCHES,
            **{k: session.cache_stats[k] - before[k] for k in keys}}


def fleet_tpch(store, sf: float, device, timed: bool) -> dict:
    """(a) and (b): the six TPC-H UDF queries (relagg on) in session A over
    an empty store, then in session B over the same data, each first call
    a store hit whose rows are A's bit for bit, whose explain is A's and
    whose loaded plan explains as A's plan; then A's Q12 entry cut in half
    and a third session over it: a ``PlanCacheWarning``, a rebuild, A's
    rows and the entry saved again."""
    import warnings

    from repro_torch.core import optimizer as O
    from repro_torch.data.tpch_udfs import QUERIES
    from repro_torch.persist import PlanCacheWarning, codec

    policy = routed_policies()[0]  # FROID, relagg on
    a = fleet_tpch_session(store, sf, device)
    t0 = time.perf_counter()
    token = a._content_env_token()
    digest_s = time.perf_counter() - t0
    calls_a = {name: first_call(a, QUERIES[name][0](), policy) for name in QUERY_NAMES}
    for name, f in calls_a.items():
        check(f["persist_misses"] == 1 and f["persist_hits"] == 0, f"(a) A {name}: {f}")
    check(a.persist_stats["saves"] == len(QUERY_NAMES) and not a.persist_stats["save_errors"],
          f"(a) A saves: {a.persist_stats}")
    store_bytes, entries = a.store.nbytes(), len(a.store.entries())
    b = fleet_tpch_session(store, sf, device)
    t0 = time.perf_counter()
    check(b._content_env_token() == token, "(a) B's content token is not A's")
    digest_b_s = time.perf_counter() - t0
    calls_b = {}
    for name in QUERY_NAMES:
        fa, fb = calls_a[name], first_call(b, QUERIES[name][0](), policy)
        calls_b[name] = fb
        check(fb["persist_hits"] == 1 and fb["persist_misses"] == 0
              and fb["persist_rejects"] == 0, f"(a) B {name} not a store hit: {fb}")
        bit_equal_tables(fa["result"].table, fb["result"].table, f"(a) {name} B vs A")
        check(address_free(fb["result"].explain) == address_free(fa["result"].explain),
              f"(a) {name}: B's explain is not A's")
        _, blob = b.store.get(b._persist_key("exec", fb["stmt"]._query_fp, policy))
        check(address_free(O.explain(codec.load_plan(blob)))
              == address_free(fa["result"].explain), f"(a) {name}: the loaded plan differs")
        if b.device.type == "cuda":  # off the card relagg takes its plain version
            check(fb["relagg_launches"] > 0 or name not in ("Q5", "Q12"),
                  f"(a) B {name}: relagg did not launch")
            check_on_card(fb["result"], f"(a) B {name}")
    check(b.persist_stats["saves"] == 0, f"(a) B saved: {b.persist_stats}")
    # (b) a damaged entry
    victim = "Q12"
    path = a.store.path_for(a._persist_key("exec", calls_a[victim]["stmt"]._query_fp, policy))
    with open(path, "r+b") as f:
        f.truncate(path.stat().st_size // 2)
    c = fleet_tpch_session(store, sf, device)
    c._content_env_token()  # the digest, apart from the rebuild's time
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fc = first_call(c, QUERIES[victim][0](), policy)
    warned = [w for w in caught if issubclass(w.category, PlanCacheWarning)]
    check(len(warned) == 1 and fc["persist_rejects"] == 1 and fc["persist_hits"] == 0
          and c.persist_stats["saves"] == 1, f"(b) damaged {victim}: {fc}, {c.persist_stats}")
    bit_equal_tables(calls_a[victim]["result"].table, fc["result"].table, f"(b) {victim} vs A")
    check(c.store.get(c._persist_key("exec", fc["stmt"]._query_fp, policy)) is not None,
          f"(b) {victim}: the entry was not saved again")
    out = {"sf": sf, "digest_s": digest_s, "digest_b_s": digest_b_s,
           "store_bytes": store_bytes, "entries": entries,
           "A_first_ms": {n: f["ms"] for n, f in calls_a.items()},
           "B_first_ms": {n: f["ms"] for n, f in calls_b.items()},
           "B_relagg_launches": {n: f["relagg_launches"] for n, f in calls_b.items()},
           "damaged": {"query": victim, "warning": str(warned[0].message)[:120],
                       "first_ms": fc["ms"]}}
    if timed:
        log(f"fleet (a) TPC-H SF {sf}, relagg on: content digest of the catalog "
            f"{digest_s:.3f} s (B {digest_b_s:.3f} s); store {entries} entries, "
            f"{store_bytes} bytes; first call ms A (cold, saves) / B (store hit): "
            + ", ".join(f"{n} {calls_a[n]['ms']:.2f}/{calls_b[n]['ms']:.2f}"
                        for n in QUERY_NAMES)
            + f"; B == A bit for bit, explain and loaded plan == A's; relagg in B: "
            + ", ".join(f"{n} {calls_b[n]['relagg_launches']}" for n in QUERY_NAMES))
        log(f"fleet (b) {victim}'s entry cut to half: PlanCacheWarning, rebuilt in "
            f"{fc['ms']:.2f} ms, == A bit for bit, saved again")
    del a, b, c, calls_a, calls_b
    return out


def fleet_query(i: int):
    """``benchmarks/bench_fleet.py:53-65``'s ``_query``: statement ``i`` of
    the population, each with its own plan fingerprint."""
    import repro_torch.core as C

    col, param = C.col, C.param
    q = C.scan("T")
    q = q.filter(col("a") < param("lo")) if i % 2 == 0 else q.filter(col("a") >= param("lo"))
    if i % 3 == 0:
        q = q.compute(**{f"w{i}": col("a") * param("scale")})
    elif i % 3 == 1:
        q = q.compute(**{f"w{i}": col("a") + param("scale") * float(i + 1)})
    else:
        q = q.compute(**{f"w{i}": col("a") * 1.0 - param("scale") / float(i)})
    return q.project("a", f"w{i}")


def fleet_setup(rows: int):
    """``bench_fleet._setup_factory``: ``T`` of ``rows`` rows (seed 0) and the
    population prepared under FROID, as a ``FleetEngine`` setup."""
    import repro_torch.core as C

    def setup(session) -> dict:
        rng = np.random.default_rng(0)
        session.create_table("T", a=rng.integers(0, 400, rows))
        return {f"s{i}": session.prepare(fleet_query(i), C.FROID)
                for i in range(FLEET_STATEMENTS)}

    return setup


def fleet_trace(k: int) -> list:
    """``bench_fleet._trace``: ``k`` requests over the population (seed 5)."""
    rng = np.random.default_rng(5)
    return [(f"s{int(rng.integers(0, FLEET_STATEMENTS))}",
             {"lo": int(rng.integers(0, 400)),
              "scale": float(round(rng.uniform(0.5, 2.0), 2))}) for _ in range(k)]


def same_on_device(want, got, label: str) -> None:
    """``bench_fleet._check_identical`` on the results' device: masks
    exactly, every column to rtol 1e-5 on the selected rows."""
    import torch

    check(len(want) == len(got), f"{label}: {len(got)} results for {len(want)}")
    for j, (w, g) in enumerate(zip(want, got)):
        wm, gm = w.masked, g.masked
        check(torch.equal(wm.mask, gm.mask), f"{label}[{j}]: masks differ")
        for n, c in wm.table.columns.items():
            check(torch.allclose(gm.table.columns[n].data[wm.mask], c.data[wm.mask],
                                 rtol=1e-5), f"{label}[{j}]: {n} differs")


def fleet_population(store, rows: int, k: int, device, timed: bool) -> dict:
    """(c): ``bench_fleet.py``'s rows with ``T`` at ``rows`` rows: the
    first call of each of the 12 statements in a fresh session over an
    empty store and again over the filled one (the per-statement ratio the
    benchmark printed, not gated), then its ``k``-request trace drained by
    one session's scheduler and by ``FleetEngine`` with one worker and with
    two (``parallel=True``: two host threads issuing on one stream), one
    warm-up drain and :data:`FLEET_TIMED_DRAINS` timed drains each, every
    ticket == the serial oracle, p50/p99 from ``latencies_s``."""
    import repro_torch.core as C
    from repro_torch.serve import CoalescingScheduler, FleetEngine

    params = {"lo": 200, "scale": 1.5}

    def first_calls():
        s = C.Session(device=device, store=store)
        stmts = fleet_setup(rows)(s)
        s.synchronize()
        t0 = time.perf_counter()
        rs = [stmts[f"s{i}"].execute(params=params) for i in range(FLEET_STATEMENTS)]
        return time.perf_counter() - t0, rs, s

    t_cold, rs_cold, s_cold = first_calls()
    check(s_cold.persist_stats["saves"] >= FLEET_STATEMENTS, f"(c) cold: {s_cold.persist_stats}")
    t_warm, rs_warm, s_warm = first_calls()
    check(s_warm.cache_stats["persist_hits"] >= FLEET_STATEMENTS
          and s_warm.cache_stats["persist_misses"] == 0, f"(c) warm: {s_warm.cache_stats}")
    same_on_device(rs_cold, rs_warm, "(c) warm vs cold first calls")
    del rs_cold, rs_warm, s_cold, s_warm
    trace = fleet_trace(k)
    oracle = C.Session(device=device)
    o_stmts = fleet_setup(rows)(oracle)
    expected = [o_stmts[name].execute(params=p) for name, p in trace]
    arms = {}
    single = C.Session(device=device, store=store)
    stmts = fleet_setup(rows)(single)
    sched = CoalescingScheduler(max_batch=1024, window_s=10.0)
    ts = []
    for _ in range(FLEET_TIMED_DRAINS):
        t0 = time.perf_counter()
        tickets = [sched.submit(stmts[name], p) for name, p in trace]
        sched.flush()
        got = [t.result() for t in tickets]
        ts.append(time.perf_counter() - t0)
        same_on_device(expected, got, "(c) single engine vs serial")
        del got, tickets
    arms["single"] = {"ms": [t * 1e3 for t in ts]}
    del single, stmts, sched
    for workers in (1, 2):
        fleet = FleetEngine(fleet_setup(rows), workers=workers, store=store,
                            parallel=workers > 1, device=device)
        for name, p in trace:
            fleet.submit(name, p)
        same_on_device(expected, fleet.drain(), f"(c) {workers}w warm-up vs serial")
        n0 = len(fleet.latencies_s)
        ts = []
        for _ in range(FLEET_TIMED_DRAINS):
            t0 = time.perf_counter()
            for name, p in trace:
                fleet.submit(name, p)
            got = fleet.drain()
            ts.append(time.perf_counter() - t0)
            same_on_device(expected, got, f"(c) {workers}w vs serial")
            del got
        lat = np.asarray(fleet.latencies_s[n0:]) * 1e3
        st = fleet.stats["fleet"]
        check(st["persist_hits"] >= 1, f"(c) {workers}w: {st}")
        arms[f"{workers}w"] = {"ms": [t * 1e3 for t in ts],
                               "p50_ms": float(np.percentile(lat, 50)),
                               "p99_ms": float(np.percentile(lat, 99)),
                               "persist_hits": st["persist_hits"]}
        del fleet
    best = {n: min(v["ms"]) for n, v in arms.items()}
    out = {"rows": rows, "trace": k, "cold_first_ms": t_cold * 1e3,
           "warm_first_ms": t_warm * 1e3, "warm_speedup": t_cold / t_warm, "arms": arms,
           "vs_single": {n: best["single"] / best[n] for n in ("1w", "2w")}}
    if timed:
        log(f"fleet (c) bench_fleet population, {FLEET_STATEMENTS} statements over {rows} T "
            f"rows: first calls cold {t_cold * 1e3:.2f} ms, warm (store hits) "
            f"{t_warm * 1e3:.2f} ms, ratio {out['warm_speedup']:.3f} (printed, not gated); "
            f"trace of {k}, best of {FLEET_TIMED_DRAINS} drains: single engine "
            f"{best['single']:.2f} ms, "
            + ", ".join(f"{n} {best[n]:.2f} ms (p50 {arms[n]['p50_ms']:.2f}, p99 "
                        f"{arms[n]['p99_ms']:.2f} ms; vs_single {out['vs_single'][n]:.3f})"
                        for n in ("1w", "2w"))
            + "; every ticket == the serial oracle")
    return out


def _two_threads(call, calls: int, what: str) -> list[list]:
    """``call(t, j)`` for ``j < calls`` in each of two host threads ``t``,
    released together from a barrier: each thread's results in order.
    Fails on an exception or a thread that does not end."""
    import threading

    barrier = threading.Barrier(2)
    outs: list[list] = [[], []]
    errors: list = []

    def work(t: int) -> None:
        try:
            barrier.wait(timeout=60)
            for j in range(calls):
                outs[t].append(call(t, j))
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not errors and not any(th.is_alive() for th in threads), f"{what}: {errors}")
    return outs


def _relagg_global_unlocked(gid, mask, vals, groups: int):
    """The control of :func:`relagg_threads`: ``relagg_cuda``'s global path
    on the stream's kept accumulator, as the binding launched it before it
    took the stream's launch lock (not counted in ``ops.LAUNCHES``)."""
    import torch

    from repro_torch.kernels.relagg import relagg as binding

    (n, k), index = vals.shape, vals.device.index
    lib = binding._lib()
    dev = binding._device(lib, index)
    plan = binding.launch_plan(dev.sm_count, dev.smem_budget, n, groups, k)
    check(not plan.shared, "relagg threads: the control's shape takes the shared path")
    stream = torch._C._cuda_getCurrentRawStream(index)
    out = torch.empty((groups, k + 1), dtype=torch.float32, device=vals.device)
    scratch = dev.scratch_for(stream, False, plan.scratch_slots)
    binding._raise(lib, lib.relagg_global(
        gid.data_ptr(), mask.data_ptr(), vals.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n, plan.per_block, k, groups, plan.grid, plan.smem, 1, 1, 0, 0, 0, stream), "launch")
    return out.narrow(1, 0, k), out.select(1, k)


def relagg_threads() -> dict:
    """Two host threads launching relagg at once on the card's current
    stream.  (1) :data:`RELAGG_THREAD_CALLS` calls each over
    :data:`RELAGG_THREAD_SHAPES` (both paths, the threads' shapes offset).
    (2) :data:`RELAGG_THREAD_GLOBAL_CALLS` calls each, both threads on the
    global path's shape (150,000 groups) at once: its two kernels share the
    stream's kept accumulator, which the binding's launch lock keeps
    together on the stream.  Every result against its float64 sums and
    counts, and the launch count exact.  (3) The control: (2) through
    :func:`_relagg_global_unlocked`, the binding without that lock, whose
    wrong results are counted and printed, not gated (the race is a matter
    of timing); it shows whether (2) could see the fault in this run."""
    import torch

    from repro_torch.kernels.relagg import ops
    from repro_torch.kernels.relagg.relagg import uses_shared

    inputs = [relagg_inputs(n, G, k, seed=900 + i)
              for i, (n, G, k) in enumerate(RELAGG_THREAD_SHAPES)]
    refs = [f64_reference(*inp, RELAGG_THREAD_SHAPES[i][1]) for i, inp in enumerate(inputs)]
    _, G, k = RELAGG_THREAD_SHAPES[-1]
    check(not uses_shared(G, k), "relagg threads: the last shape takes the shared path")

    def mixed(t: int, j: int):
        i = (j + t) % len(inputs)
        gid, mask, vals = inputs[i]
        return i, ops.grouped_aggregate(gid, mask, vals, RELAGG_THREAD_SHAPES[i][1])

    ops.LAUNCHES = 0
    outs = _two_threads(mixed, RELAGG_THREAD_CALLS, "relagg threads, mixed shapes")
    mixed_launches = ops.LAUNCHES
    check(mixed_launches == 2 * RELAGG_THREAD_CALLS,
          f"relagg threads: {mixed_launches} launches counted")
    for t in range(2):
        for i, (sums, counts) in outs[t]:
            ref_sums, absum, ref_counts = refs[i]
            check(np.array_equal(counts.cpu().numpy(), ref_counts.astype(np.float32))
                  and (np.abs(sums.cpu().numpy().astype(np.float64) - ref_sums)
                       <= 1e-4 * absum).all(), f"relagg thread {t} shape {i} is wrong")

    ref_sums, absum, ref_counts = (torch.from_numpy(np.asarray(x)).cuda() for x in refs[-1])
    ref_counts, tol = ref_counts.float(), 1e-4 * absum

    def wrong(results) -> int:
        return sum(not (torch.equal(counts, ref_counts)
                        and bool(((sums.double() - ref_sums).abs() <= tol).all()))
                   for t in range(2) for sums, counts in results[t])

    gid, mask, vals = inputs[-1]
    control = _two_threads(lambda t, j: _relagg_global_unlocked(gid, mask, vals, G),
                           RELAGG_THREAD_GLOBAL_CALLS, "relagg threads, control")
    control_wrong = wrong(control)
    del control
    ops.LAUNCHES = 0
    locked = _two_threads(lambda t, j: ops.grouped_aggregate(gid, mask, vals, G),
                          RELAGG_THREAD_GLOBAL_CALLS, "relagg threads, global path")
    global_launches = ops.LAUNCHES
    check(global_launches == 2 * RELAGG_THREAD_GLOBAL_CALLS,
          f"relagg threads: {global_launches} global-path launches counted")
    global_wrong = wrong(locked)
    check(global_wrong == 0, f"relagg threads: {global_wrong} of "
          f"{2 * RELAGG_THREAD_GLOBAL_CALLS} global-path results wrong from two threads")
    return {"threads": 2, "launches": mixed_launches + global_launches,
            "mixed_launches": mixed_launches, "global_launches": global_launches,
            "global_wrong": global_wrong, "control_calls": 2 * RELAGG_THREAD_GLOBAL_CALLS,
            "control_wrong": control_wrong}


def fleet_routing(store, detail_rows: int, per_stmt: int, device, timed: bool) -> dict:
    """(d): the routed phase's queue (``bench_cost_routing.py``'s, 3
    statements x ``per_stmt``) over the invocation tables, drained by a
    two-worker ``ROUTED`` fleet (relagg on, fused drains, ``parallel=True``)
    as the routed phase drains it: two routed drains (the router explores
    the fused arm, then the per-statement one), then, until each worker's
    router has measured both fuse arms, each worker's static FROID arms
    (fused, per statement; the same fingerprint, so they train its
    router) in turns with a routed drain; then ``save_costs``.  The static
    arms are what supply the per-statement arm's evidence: the exploring
    drain sends ``key_total`` to HEKATON on its estimate, and its samples
    land under HEKATON's fingerprint, not under the one the fuse axis
    reads.  Then a fresh two-worker fleet over the same store, routed
    drains only: each worker loads the costs, and its routers explore no
    arm.  Every ticket == the static serial loop == float64."""
    import repro_torch.core as C
    from repro_torch.kernels.relagg import ops
    from repro_torch.serve import CoalescingScheduler, FleetEngine

    static, routed = routed_policies()
    db = C.Session(device=device)
    a, sums, tol = load_invocation(db, detail_rows)
    s_stmts = [db.prepare(q, static) for q in routing_queries()]
    queue = routing_queue(s_stmts, per_stmt)
    serial = [s.execute(params=p) for s, p in queue]
    check_fused_tickets(serial, queue, s_stmts, a, sums, tol, "(d) serial vs float64",
                        routing_expected)
    names = [f"s{s_stmts.index(s)}" for s, _ in queue]

    def setup(session) -> dict:
        load_invocation(session, detail_rows)
        return {**{f"s{i}": session.prepare(q, routed) for i, q in enumerate(routing_queries())},
                **{f"f{i}": session.prepare(q, static) for i, q in enumerate(routing_queries())}}

    def fleet():
        return FleetEngine(setup, workers=2, store=store, parallel=True, device=device,
                           scheduler_factory=lambda: CoalescingScheduler(
                               max_batch=1024, window_s=10.0, fuse=True))

    def run(fl, label: str) -> dict:
        routers = [w.session.cost_router for w in fl.workers]
        before = [r.stats["decisions"] for r in routers]
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        for name, (_, p) in zip(names, queue):
            fl.submit(name, p)
        got = fl.drain()
        ms = (time.perf_counter() - t0) * 1e3
        same_results(serial, got, f"(d) {label} vs serial")
        check_fused_tickets(got, queue, s_stmts, a, sums, tol, f"(d) {label} vs float64",
                            routing_expected)
        logged = [new_decisions(r, b) for r, b in zip(routers, before)]
        return {"ms": ms, "relagg_launches": ops.LAUNCHES,
                "fuse": [[d["why"] for d in w if d["axis"] == "fuse"] for w in logged],
                "policy": [[(d["choice"], d["why"]) for d in w if d["axis"] == "policy"]
                           for w in logged]}

    def measured(d: dict) -> bool:
        return all(w and all(why == "measured" for why in w) for w in d["fuse"])

    first = fleet()
    drains = [run(first, "first fleet drain 0"), run(first, "first fleet drain 1")]
    while not measured(drains[-1]) and len(drains) < FLEET_MEASURE_DRAINS:
        for w in first.workers:  # the static arms, on each worker's session
            static_q = [(w.statements[name.replace("s", "f")], p)
                        for name, (_, p) in zip(names, queue)]
            for fuse in (True, False):
                same_results(serial, drain(static_q, fuse)[0],
                             f"(d) worker {w.wid} static fuse={fuse} vs serial")
        drains.append(run(first, f"first fleet drain {len(drains)}"))
    check(measured(drains[-1]), f"(d) the first fleet did not measure: "
          f"{[d['fuse'] for d in drains]}")
    saved = first.save_costs()
    check(saved == 2, f"(d) {saved} workers saved costs")
    del first
    fresh = fleet()
    loaded = [w.session.persist_stats["costs_loaded"] for w in fresh.workers]
    check(all(n > 0 for n in loaded), f"(d) costs loaded per worker: {loaded}")
    fresh_drains = [run(fresh, f"fresh fleet drain {i}") for i in range(FLEET_ROUTED_SHOWN)]
    explored = [why for d in fresh_drains for w in d["fuse"] for why in w
                if why.startswith("explore")]
    check(not explored and all(w for d in fresh_drains for w in d["fuse"]),
          f"(d) the warm-started fleet explored: {[d['fuse'] for d in fresh_drains]}")
    out = {"detail_rows": detail_rows, "tickets": len(queue), "costs_loaded": loaded,
           "first_fleet": drains, "fresh_fleet": fresh_drains}
    if timed:
        log(f"fleet (d) routed fleets, 2 workers (parallel), {len(queue)} tickets over "
            f"{detail_rows} detail rows: first fleet measured in {len(drains)} drains, saved; "
            f"fresh fleet loaded {loaded} cost records, fuse decisions "
            f"{[d['fuse'] for d in fresh_drains]}; drain ms first fleet "
            + ", ".join(f"{d['ms']:.2f} ({'/'.join(sorted({why for w in d['fuse'] for why in w}))}"
                        f"; policy {sorted({c for w in d['policy'] for c, _ in w})})"
                        for d in drains[:FLEET_ROUTED_SHOWN])
            + " against fresh fleet " + ", ".join(f"{d['ms']:.2f}" for d in fresh_drains)
            + f"; relagg launches a fresh drain {[d['relagg_launches'] for d in fresh_drains]}"
            "; every ticket == serial == float64")
    del fresh, db, serial
    return out


def fleet_admission(store, device) -> dict:
    """(e): ``AdmissionPolicy(store=...)`` cold, then a second policy over
    the same store: its request statement is a store hit, its verdicts the
    cold ones and the rules written out in Python.  Each policy's scheduler
    is the one it builds by default, on a clock that does not advance: on
    ``time.monotonic`` a busy host can let the flush window close a batch
    early, and the warm drain's other bucket then saves a new entry."""
    from repro_torch.serve.admission import AdmissionPolicy
    from repro_torch.serve.scheduler import CoalescingScheduler

    n = FLEET_ADMISSION_REQUESTS
    rng = np.random.default_rng(3)
    fields = {"tier": rng.integers(0, 3, n), "prompt_len": rng.integers(1, 40_000, n),
              "max_new_tokens": rng.integers(1, 5_000, n),
              "temperature": rng.uniform(-0.5, 2.5, n).astype(np.float32)}
    want = [expected_verdict(int(fields["tier"][i]), int(fields["prompt_len"][i]),
                             int(fields["max_new_tokens"][i]),
                             float(fields["temperature"][i]), n) for i in range(n)]
    out, verdicts = {}, {}
    for phase in ("cold", "warm"):
        sched = CoalescingScheduler(clock=lambda: 0.0, fuse=False, adaptive=False,
                                    default_timeout_s=None)
        ap = AdmissionPolicy(device=device, store=store, scheduler=sched)
        t0 = time.perf_counter()
        got = ap.evaluate_coalesced(fields)
        ms = (time.perf_counter() - t0) * 1e3
        check([(bool(x), int(g)) for x, g in zip(got["admit"], got["granted"])]
              == [(x, g) for x, g, _ in want]
              and np.allclose(got["temp"], [t for _, _, t in want], rtol=1e-6),
              f"(e) admission {phase}: the verdicts are not the rules'")
        rs = ap._request_session
        out[phase] = {"ms": ms, "persist_hits": rs.cache_stats["persist_hits"],
                      "saves": rs.persist_stats["saves"]}
        verdicts[phase] = got
    check(out["cold"]["saves"] >= 1 and out["warm"]["persist_hits"] >= 1
          and out["warm"]["saves"] == 0, f"(e) admission store: {out}")
    for k in verdicts["cold"]:
        check(np.array_equal(verdicts["cold"][k], verdicts["warm"][k]),
              f"(e) admission: warm {k} differs from cold")
    return out


def fleet_run(device, sf: float, t_rows: int, k: int, detail_rows: int, per_stmt: int,
              timed: bool) -> dict:
    """(a)-(e) on ``device``, each over its own store directory in a
    temporary directory removed at the end."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="fleet_store_") as root:
        root = pathlib.Path(root)
        out = {"tpch": fleet_tpch(root / "tpch", sf, device, timed)}
        gc.collect()
        out["population"] = fleet_population(root / "population", t_rows, k, device, timed)
        gc.collect()
        if timed:
            out["relagg_threads"] = relagg_threads()
            r = out["relagg_threads"]
            log(f"fleet (c) relagg from two host threads on one stream: "
                f"{r['mixed_launches']} launches over mixed shapes and "
                f"{r['global_launches']} both on the global path (150,000 groups) at once "
                f"counted, every result == its float64 sums and counts; control without "
                f"the launch lock: {r['control_wrong']} of {r['control_calls']} results "
                "wrong (not gated)")
        out["routing"] = fleet_routing(root / "routing", detail_rows, per_stmt, device, timed)
        gc.collect()
        out["admission"] = fleet_admission(root / "admission", device)
        if timed:
            e = out["admission"]
            log(f"fleet (e) AdmissionPolicy(store=...): cold {e['cold']['ms']:.2f} ms "
                f"({e['cold']['saves']} saves), warm {e['warm']['ms']:.2f} ms "
                f"({e['warm']['persist_hits']} store hits); verdicts == cold == the rules")
    return out


def fleet_phase() -> dict:
    """The persistent plan store and the fleet on the card: (a) TPC-H at SF 1
    from an empty store and then from A's entries, (b) a damaged entry,
    (c) ``bench_fleet.py``'s population at 6,000,000 ``T`` rows and its
    fleet drains, with relagg from two host threads, (d) routing warm
    start over the invocation tables, (e) admission over a store."""
    import torch

    t0 = time.perf_counter()
    out = fleet_run(None, 1.0, FLEET_T_ROWS, FLEET_TRACE_K, INVOCATION_ROWS["detail"],
                    ROUTING_PER_STMT, timed=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"fleet phase ok in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# mesh phase: policy.sharded(mesh), the sharded execute_many, fused wave,
# scheduler, admission, store and router tiers
# ---------------------------------------------------------------------------

#: the sharded legs' mesh positions, every one over the same device
MESH_SHARDS = (2, 4)
MESH_SWEEP = (32, 1024)
MESH_ROUNDS = 5


def same_device_mesh(device, k: int):
    """A ``k``-position data mesh naming ``device`` ``k`` times."""
    from repro_torch.launch.mesh import make_small_mesh

    return make_small_mesh(data=k, devices=[device] * k)


def mesh_key_total(db, a, sums, tol, meshes: dict, sweep, rounds: int, timed: bool) -> dict:
    """(a): ``key_total`` through ``execute_many`` at each N of ``sweep``,
    unsharded and sharded over each mesh of ``meshes`` (label -> mesh), in
    turns for ``rounds`` timed calls after a warm call of each; every
    ticket against float64 and the serial loop, the sharded sums against
    the unsharded bit for bit, relagg once a shard a call, and the shard
    cache's hits over the warm calls."""
    import repro_torch.core as C

    base = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    stmts = {"unsharded": db.prepare(key_total_query(), base)}
    shards = {"unsharded": 1}
    for label, mesh in meshes.items():
        stmts[label] = db.prepare(key_total_query(), base.sharded(mesh))
        shards[label] = stmts[label].policy.shard_devices()
    rng = np.random.default_rng(13)
    out: dict = {}
    for n in sweep:
        cutoffs = rng.integers(1, INVOCATION_ROWS["keys"], n)
        plist = [{"cutoff": int(c)} for c in cutoffs]
        serial = [stmts["unsharded"].execute(params=p) for p in plist]
        check_key_totals(serial, cutoffs, a, sums, tol, f"(a) serial N={n}")
        row: dict = {}
        warm = {}
        for label, stmt in stmts.items():
            before = db.cache_stats["shard_misses"]
            warm[label] = stmt.execute_many(plist)  # the first call of this bucket
            row[label] = {"shard_misses_first_call": db.cache_stats["shard_misses"] - before,
                          "runs": []}
        hits0 = db.cache_stats["shard_hits"]
        for _ in range(rounds):
            for label, stmt in stmts.items():
                r = arm(lambda stmt=stmt: stmt.execute_many(plist))
                row[label]["runs"].append(r)
        for label, stmt in stmts.items():
            runs = row[label].pop("runs")
            res = runs[-1]["out"]
            check_key_totals(res, cutoffs, a, sums, tol, f"(a) {label} N={n}")
            same_tickets(serial, res, "v", f"(a) {label} vs serial N={n}", exact=False)
            st = res[0].stats
            sharded = shards[label] > 1
            check(st.get("sharded", False) == sharded
                  and st.get("shard_devices", 1) == shards[label]
                  and st["batch_size"] == n and st["batch_bucket"] == C.batch_bucket(n, 1024),
                  f"(a) {label} N={n}: {st}")
            # the kernel launches on the card only (the CPU runs its plain version)
            want = shards[label] if db.device.type == "cuda" else 0
            launches = [r["relagg_launches"] for r in runs]
            check(all(x == want for x in launches)
                  and all(r["relagg_batched_launches"] == 0 for r in runs),
                  f"(a) {label} N={n}: relagg launches {launches}, want {want} a call")
            walls = sorted(r["wall_s"] for r in runs)
            row[label].update({
                "shard_devices": shards[label],
                "us_per_invocation": walls[len(walls) // 2] / n * 1e6,
                "dispatch_s": st["dispatch_s"], "sync_s": st["sync_s"],
                "relagg_launches_per_call": launches[-1],
                "batch_bucket": st["batch_bucket"],
                "peak_gb": runs[-1]["peak_gb"]})
            if sharded:
                row[label]["max_abs_diff_vs_unsharded"] = same_tickets(
                    warm["unsharded"], res, "v", f"(a) {label} vs unsharded N={n}",
                    exact=False)
                um, uv = stacked(warm["unsharded"], "v")
                sm, sv = stacked(res, "v")
                row[label]["bit_equal_to_unsharded"] = bool(np.array_equal(uv[um], sv[sm]))
        row["shard_hits_warm_calls"] = db.cache_stats["shard_hits"] - hits0
        sharded_labels = [x for x in stmts if shards[x] > 1]
        check(row["shard_hits_warm_calls"] == rounds * len(sharded_labels)
              and all(row[x]["shard_misses_first_call"] == 1 for x in sharded_labels),
              f"(a) N={n}: shard cache {row}")
        out[n] = row
        if timed:
            u = row["unsharded"]["us_per_invocation"]
            parts = []
            for label in stmts:
                r = row[label]
                parts.append(
                    f"{label} {r['us_per_invocation']:.1f} µs an invocation "
                    f"(x{r['us_per_invocation'] / u:.2f}; {r['shard_devices']} shard(s), "
                    f"dispatch {r['dispatch_s'] * 1e3:.2f} ms, sync {r['sync_s'] * 1e3:.2f} ms, "
                    f"relagg {r['relagg_launches_per_call']} a call"
                    + (f", bit-equal to unsharded {r['bit_equal_to_unsharded']}"
                       + ("" if r["bit_equal_to_unsharded"] else
                          f" (max |diff| {r['max_abs_diff_vs_unsharded']:.3g})")
                       if r["shard_devices"] > 1 else "") + ")")
            log(f"mesh (a) key_total N={n}: " + "; ".join(parts)
                + f"; shard hits over the {rounds} warm rounds {row['shard_hits_warm_calls']}"
                "; every ticket == float64 and serial")
    return out


#: ``tests/test_fused.py:434-457``'s mixed-divisibility spec (8 + 3 tickets
#: and a parameter-free member), and 8 + 2 tickets, whose 2-ticket member
#: pads its bucket up to the 4 positions
MESH_FUSED_SPECS = {
    "mixed_divisibility": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
                           + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(3)]
                           + [(2, None) for _ in range(2)]),
    "padded": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
               + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(2)]
               + [(2, None) for _ in range(2)]),
}


def mesh_fused(device, rows: int, mesh) -> dict:
    """(b): each spec of :data:`MESH_FUSED_SPECS` through a fusion-mode
    scheduler over ``mesh`` on the fusion oracle's session: one sharded
    wave, member buckets 8, 4 and 1, every ticket == the serial loop."""
    import repro_torch.core as C
    from repro_torch.serve.scheduler import CoalescingScheduler

    db = fusion_oracle_session(rows, device)
    policy = C.FROID.sharded(mesh)
    stmts = [db.prepare(q, policy) for q in fusion_oracle_queries()]
    out = {}
    for name, spec in MESH_FUSED_SPECS.items():
        sched = CoalescingScheduler(max_batch=256, window_s=10.0, fuse=True)
        tickets = [sched.submit(stmts[i], p) for i, p in spec]
        sched.flush()
        fused = [t.result() for t in tickets]
        for j, ((i, p), r) in enumerate(zip(spec, fused)):
            same_masked(stmts[i].execute(params=p), r, f"(b) {name}[{j}] vs serial")
        buckets = [r.stats.get("batch_bucket") for r in fused]
        check(all(r.stats.get("fused") and r.stats.get("sharded")
                  and r.stats.get("shard_devices") == mesh.shape["data"] for r in fused),
              f"(b) {name}: not one sharded wave: {fused[0].stats}")
        check(buckets == [8] * 8 + [4] * (len(spec) - 10) + [1, 1],
              f"(b) {name}: buckets {buckets}")
        check(sched.stats["fused_batches"] == 1, f"(b) {name}: {sched.stats}")
        out[name] = {"tickets": len(spec), "buckets": sorted(set(buckets)),
                     "sizes": [sum(1 for i, _ in spec if i == s) for s in range(3)]}
    return out


def mesh_intake(device, db, a, sums, tol, mesh) -> dict:
    """(c): ``AdmissionPolicy(mesh=...)``'s coalesced verdicts == its tick
    verdicts == the rules, its request statement sharded; and a
    ``CoalescingScheduler`` flushing a sharded ``key_total`` statement
    (``max_batch=2``) at ``max_batch × devices`` tickets."""
    import repro_torch.core as C
    from repro_torch.serve.admission import AdmissionPolicy
    from repro_torch.serve.scheduler import CoalescingScheduler

    k = mesh.shape["data"]
    ap = AdmissionPolicy(device=device, mesh=mesh)
    rng = np.random.default_rng(5)
    n = 8 * k
    reqs = {"tier": rng.integers(0, 3, n), "prompt_len": rng.integers(10, 40000, n),
            "max_new_tokens": rng.integers(1, 9000, n),
            "temperature": rng.uniform(-1, 3, n).astype(np.float32)}
    tick, co = ap.evaluate(reqs), ap.evaluate_coalesced(reqs)
    for name in ("admit", "granted", "temp"):
        check(np.array_equal(tick[name], co[name]), f"(c) admission {name}: coalesced != tick")
    for i in range(n):
        want = expected_verdict(int(reqs["tier"][i]), int(reqs["prompt_len"][i]),
                                int(reqs["max_new_tokens"][i]),
                                float(reqs["temperature"][i]), n)
        got = (bool(co["admit"][i]), int(co["granted"][i]), float(co["temp"][i]))
        check(got[:2] == want[:2] and abs(got[2] - want[2]) <= 1e-6 * max(1.0, abs(want[2])),
              f"(c) admission request {i}: {got} != the rules' {want}")
    stmt = ap.request_statement()
    check(stmt.policy.shard_devices() == k and ap.scheduler.stats["batches"] == 1,
          f"(c) admission: {stmt.policy.shard_devices()} shards, {ap.scheduler.stats}")
    policy = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    kt = db.prepare(key_total_query(), policy.sharded(mesh).batched(max_batch=2))
    sched = CoalescingScheduler(window_s=10.0, clock=lambda: 0.0)
    cutoffs = np.random.default_rng(17).integers(1, INVOCATION_ROWS["keys"], 2 * k)
    tickets = [sched.submit(kt, {"cutoff": int(c)}) for c in cutoffs[:-1]]
    pending = sched.pending
    tickets.append(sched.submit(kt, {"cutoff": int(cutoffs[-1])}))
    check(pending == 2 * k - 1 and sched.pending == 0 and sched.stats["flush_full"] == 1,
          f"(c) scheduler: pending {pending} then {sched.pending}, {sched.stats}")
    res = [t.result() for t in tickets]
    check_key_totals(res, cutoffs, a, sums, tol, "(c) scheduler flush")
    st = res[0].stats
    check(st["sharded"] and st["batch_size"] == 2 * k, f"(c) scheduler: {st}")
    return {"admission_requests": n, "admission_shards": k, "flush_size": st["batch_size"]}


def mesh_store(device, detail_rows: int, mesh, root) -> dict:
    """(d): session A over an empty store runs ``key_total`` sharded over
    ``mesh`` (N = 32) and writes its ``"shard"`` entry; session B over the
    same data and store hits it on its first call, and its rows equal A's
    bit for bit."""
    import repro_torch.core as C

    policy = C.ExecutionPolicy(name="froid+relagg", pallas_agg=True).sharded(mesh)
    plist = [{"cutoff": int(c)} for c in
             np.random.default_rng(19).integers(1, INVOCATION_ROWS["keys"], 32)]
    out = {}
    results = {}
    for name in ("A", "B"):
        db = C.Session(device=device, store=root)
        a, sums, tol = load_invocation(db, detail_rows)
        stmt = db.prepare(key_total_query(), policy)
        results[name] = stmt.execute_many(plist)
        check_key_totals(results[name], [p["cutoff"] for p in plist], a, sums, tol,
                         f"(d) session {name}")
        key = db._persist_key("shard", stmt._query_fp, stmt.policy,
                              sig=C.param_signature(plist[0]), bucket=32,
                              shard_token=stmt.policy.shard_token())
        out[name] = {**{k: db.cache_stats[k] for k in
                        ("persist_hits", "persist_misses", "shard_misses")},
                     "saves": db.persist_stats["saves"],
                     "shard_entry": db.store.get(key) is not None}
        del db, stmt
        gc.collect()
    check(out["A"]["persist_hits"] == 0 and out["A"]["saves"] == 2
          and out["A"]["shard_entry"], f"(d) A: {out['A']}")
    check(out["B"]["persist_hits"] == 2 and out["B"]["persist_misses"] == 0
          and out["B"]["saves"] == 0, f"(d) B did not hit the store: {out['B']}")
    same_tickets(results["A"], results["B"], "v", "(d) B vs A", exact=True)
    return out


def mesh_routed(device, rows: int, mesh) -> dict:
    """(e): ``ROUTED.sharded(mesh)`` ``execute_many`` of the fusion oracle's
    parameterized query (8 tickets, twice) == the serial FROID loop; the
    router's samples keyed by the policy's shard token.  And HEKATON
    sharded (its scan-mode hook on each shard's device) == the same."""
    import repro_torch.core as C

    db = fusion_oracle_session(rows, device)
    q = fusion_oracle_queries()[0]
    stmt = db.prepare(q, C.ROUTED.sharded(mesh))
    oracle = db.prepare(q, C.FROID)
    params = [{"cut": int(k % 6), "shift": 0.5} for k in range(8)]
    want = [oracle.execute(params=p) for p in params]
    for w in range(2):
        got = stmt.execute_many(params)
        for i, (o, g) in enumerate(zip(want, got)):
            same_masked(o, g, f"(e) routed sharded[{w}][{i}]")
    token = stmt.policy.shard_token()
    keys = [k for k in db.cost_router.measured if k[0] == "many"]
    check(keys and all(k[4] == token for k in keys), f"(e) router keys {keys}")
    hek = db.prepare(q, C.HEKATON.sharded(mesh)).execute_many(params)
    for i, (o, g) in enumerate(zip(want, hek)):
        same_masked(o, g, f"(e) HEKATON sharded[{i}]")
    check(all(r.stats.get("sharded") for r in got + hek), "(e) not sharded")
    return {"samples": db.cost_stats["samples"], "many_keys": len(keys),
            "sharded": True, "result_devices": sorted({str(r.masked.mask.device) for r in hek})}


def mesh_run(device, detail_rows: int, fusion_rows: int, sweep, rounds: int,
             timed: bool, meshes: dict | None = None) -> dict:
    """(a)-(e) over ``meshes`` (label -> mesh; by default meshes naming
    ``device`` 2 and 4 times), (b)-(e) over the last of them, the store in
    a temporary directory removed at the end."""
    import tempfile

    db, a, sums, tol = invocation_session(detail_rows, device)
    if meshes is None:
        meshes = {f"x{k}": same_device_mesh(str(db.device), k) for k in MESH_SHARDS}
    out = {"device": str(db.device),
           "key_total": mesh_key_total(db, a, sums, tol, meshes, sweep, rounds, timed)}
    mesh4 = list(meshes.values())[-1]
    out["fused"] = mesh_fused(device, fusion_rows, mesh4)
    out["intake"] = mesh_intake(device, db, a, sums, tol, mesh4)
    del db
    gc.collect()
    with tempfile.TemporaryDirectory(prefix="mesh_store_") as root:
        out["store"] = mesh_store(device, detail_rows, mesh4, root)
    out["routed"] = mesh_routed(device, fusion_rows, mesh4)
    if timed:
        f, s, r = out["fused"], out["store"], out["routed"]
        log(f"mesh (b) fused waves on {mesh4!r}: "
            + "; ".join(f"{name} {v['sizes']} tickets, buckets {v['buckets']}"
                        for name, v in f.items())
            + ", one sharded wave each, every ticket == serial")
        log(f"mesh (c) AdmissionPolicy(mesh=...): {out['intake']['admission_requests']} "
            f"requests coalesced == tick == the rules on {out['intake']['admission_shards']} "
            f"shards; scheduler flushed at max_batch 2 x {out['intake']['admission_shards']}")
        log(f"mesh (d) store: A saved {s['A']['saves']} entries (the 'shard' entry present: "
            f"{s['A']['shard_entry']}); B's first call: {s['B']['persist_hits']} store hits, "
            f"{s['B']['persist_misses']} misses, == A bit for bit")
        log(f"mesh (e) ROUTED sharded execute_many: == FROID serial, {r['many_keys']} "
            f"sampled configuration(s), each keyed by the shard token; HEKATON sharded "
            f"== FROID serial, results on {r['result_devices']}")
    return out


def mesh_phase() -> dict:
    """The mesh on the card: (a)-(e) over meshes naming ``cuda:0`` 2 and 4
    times; (f) where there are several cards, (a)-(e) again over a mesh of
    every card."""
    import torch

    t0 = time.perf_counter()
    out = mesh_run(None, INVOCATION_ROWS["detail"], 20_000, MESH_SWEEP, MESH_ROUNDS,
                   timed=True)
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    if cards >= 2:
        from repro_torch.launch.mesh import make_small_mesh

        log(f"mesh (f) over every card: make_small_mesh(data={cards})")
        out["all_cards"] = mesh_run(None, INVOCATION_ROWS["detail"], 20_000, MESH_SWEEP,
                                    MESH_ROUNDS, timed=True,
                                    meshes={f"cards{cards}": make_small_mesh(data=cards)})
        gc.collect()
        torch.cuda.empty_cache()
    else:
        out["all_cards"] = None
        log("mesh (f) not run: one CUDA device here, and a mesh over several cards "
            "needs as many (make_small_mesh never maps a missing card onto another)")
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh phase ok in {out['seconds']:.1f} s")
    return out


def intake_check(model, reqs, want: dict) -> dict:
    """(c): ``ServeEngine.submit`` each request then ``drain``: the
    completions (verdicts, greedy and sampled tokens) equal ``run``'s
    (``want``: rid -> Completed), admission drained as one
    ``execute_many``."""
    import torch

    from repro_torch.serve.engine import ServeEngine

    engine = ServeEngine(model, slots=SLOTS, max_len=MAX_LEN, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {c.rid: (c.reason, c.tokens) for c in done}
    check(got == {rid: (c.reason, c.tokens) for rid, c in want.items()},
          "submit/drain completions differ from run's")
    stats = engine.admission.scheduler.stats
    check(stats["batches"] == 1 and stats["drained"] == len(reqs) and not engine.shed,
          f"submit/drain admission: {stats}")
    return {"wall_s": wall, "requests": len(reqs), "equal_to_run": True}


# source text the variants below replace
_PAIR_LOOP = ("        // one (group, column) slot a lane: the group's rows in lane order\n"
              "        for (int p = lane; p < __popc(leaders) * width; p += 32) {")
_NO_PAIR_LOOP = "        for (int p = lane; p < 0; p += 32) {"
_LEADER_SUMS = (
    "        if (sel && __ffs(peers) - 1 == lane) {\n"
    "          double* slot = acc + g * width;\n"
    "          for (int c = 0; c < k; ++c) {\n"
    "            double x = 0.0;\n"
    "            for (unsigned q = peers; q; q &= q - 1u) x += (double)stage[c * 32 + __ffs(q) - 1];\n"
    "            slot[c] += x;\n"
    "          }\n"
    "          slot[k] += (double)__popc(peers);\n"
    "        }\n")
_ONE_LEVEL = ("constexpr int kGroup = 12;", "constexpr int kGroup = 1 << 16;")
_FLUSH_EACH_WORD = ("    count += total;\n    __syncwarp();\n",
                    "    count += total;\n    __syncwarp();\n    flush();\n")
#: ``--relagg-variants``: name -> (whether it computes relagg, edits of
#: ``csrc/relagg.cu``, blocks an SM).  A design the source chose against is
#: checked against the plain version and timed; a probe leaves part of the
#: work out, so its time says what that part costs, and it is only timed.
RELAGG_VARIANTS = {
    # the direct design, which the others refine: rows added as each mask
    # word is scanned (no list), each group's lowest lane summing all its
    # columns, and the last block summing every block's partial in block
    # order
    "recommended": (True, [_FLUSH_EACH_WORD, (_PAIR_LOOP, _LEADER_SUMS + _NO_PAIR_LOOP),
                           _ONE_LEVEL], 1),
    # the list, with each group's lowest lane summing all its columns
    "leader_sums": (True, [(_PAIR_LOOP, _LEADER_SUMS + _NO_PAIR_LOOP)], 1),
    # the list, the batch's rows added one at a time in lane order, column
    # c by lane c
    "column_lanes": (True, [(_PAIR_LOOP,
                             "        for (unsigned b = selected; b; b &= b - 1u) {\n"
                             "          const int src = __ffs(b) - 1;\n"
                             "          const int gs = __shfl_sync(kFull, g, src);\n"
                             "          for (int c = lane; c <= k; c += 32)\n"
                             "            acc[gs * width + c] += c < k ? (double)stage[c * 32 + src]"
                             " : 1.0;\n"
                             "        }\n" + _NO_PAIR_LOOP)], 1),
    # the cross-block sum at one level: the last block sums every block's
    # partial in block order
    "one_level_sum": (True, [_ONE_LEVEL], 1),
    # two blocks an SM, each over half the rows
    "two_blocks_per_sm": (True, [], 2),
    # probe: no gid or vals loaded (the scan, the lists and the partials
    # and their sum)
    "probe_no_rows": (False, [("    for (int j0 = 0; j0 < count; j0 += 32) {",
                               "    for (int j0 = 0; j0 < 0; j0 += 32) {")], 1),
    # probe: gid and vals loaded and staged and the groups found, nothing
    # summed
    "probe_no_sums": (False, [(_PAIR_LOOP, _NO_PAIR_LOOP)], 1),
    # probe: no cross-block sum (every block returns after its partial)
    "probe_no_cross_block": (False, [("  if (!last_to_arrive(a.ticket + 1 + group, g1 - g0)) return;",
                                      "  if (true) return;")], 1),
    # probe: no mask word read (the launch, the partials and their sum;
    # each block's tail bytes still read)
    "probe_no_scan": (False, [("  const long long words = (hi - first) >> 4;",
                               "  const long long words = 0;")], 1),
}


def relagg_variant_library(name: str, edits) -> ctypes.CDLL:
    """``csrc/relagg.cu`` with ``edits`` applied, built with the port's own
    flags beside its libraries."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "relagg.cu").read_text()
    for old, new in edits:
        check(src.count(old) == 1, f"relagg variant {name}: the source holds {old!r} "
              f"{src.count(old)} times")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"relagg_{name}.cu"
    path.write_text(src)
    lib = path.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def relagg_variants_phase() -> dict:
    """Each variant at Q12's and Q5's inputs (TPC-H at SF 1): checked
    against the float64 sum where it computes relagg, then its device time
    (:func:`relagg_split`) in turns with the shipped kernel's (shipped,
    variant, variant, shipped)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.relagg import relagg as binding

    shipped = _build.load("relagg")
    with concurrent.futures.ThreadPoolExecutor(len(RELAGG_VARIANTS)) as pool:
        libs = dict(zip(RELAGG_VARIANTS, pool.map(
            lambda kv: shipped if not kv[1][1] else relagg_variant_library(kv[0], kv[1][1]),
            RELAGG_VARIANTS.items())))
    session = tpch_session(1.0)
    inputs = {label: capture_relagg_args(session, label) for label in ("Q12", "Q5")}
    del session

    def use(lib, blocks_per_sm=1):
        _build._loaded["relagg"] = lib
        binding._devices.clear()  # the shared-memory opt-in is the library's
        binding.launch_plan.cache_clear()
        dev = binding._device(binding._lib(), torch.cuda.current_device())
        dev.sm_count *= blocks_per_sm

    out = {}
    try:
        for label, (gid, mask, vals, G) in inputs.items():
            ref_sums, absum, ref_counts = f64_reference(gid, mask, vals, G)
            times = {}
            for name, (same, _, per_sm) in RELAGG_VARIANTS.items():
                def call():
                    return binding.relagg_cuda(gid, mask, vals, G)

                if same:
                    use(libs[name], per_sm)
                    s, c = call()
                    check(np.array_equal(c.cpu().numpy(), ref_counts.astype(np.float32)) and
                          (np.abs(s.cpu().numpy() - ref_sums) <= 1e-4 * absum).all(),
                          f"relagg variant {name} at {label}'s inputs: off the float64 sum")
                turns = []
                for lib, k in ((shipped, 1), (libs[name], per_sm), (libs[name], per_sm),
                               (shipped, 1)):
                    use(lib, k)
                    turns.append(relagg_split(call)["device_ms"])
                times[name] = {"device_ms": min(turns[1:3]),
                               "shipped_device_ms": min(turns[0], turns[3]), "turns": turns}
            out[label] = times
            log(f"relagg variants at {label}'s inputs, device ms: " + "; ".join(
                f"{n} {t['device_ms']:.5f} against shipped {t['shipped_device_ms']:.5f} "
                f"(turns {' / '.join(f'{x:.5f}' for x in t['turns'])})"
                for n, t in times.items()))
    finally:
        use(shipped)
    return out


# ---------------------------------------------------------------------------
# LM serving path: flash_attention and ssd_scan
# ---------------------------------------------------------------------------

#: serving phase: (arch, the kernel its prefill runs, runs of the request
#: mix); each is served once, to keep the script in its time (granite and
#: mamba were served twice, their tokens held equal across the runs, until
#: the whole script passed 720 s with the cross models added: 744 s on an
#: H100 whose host ran the host-paced phases ~25% slower than before).
#: minicpm3-4b's MLA layers hand flash q and k at 64 + 32 = 96 and v's 64
#: zero-padded to 96: its flash instance is <96>
SERVE_ARCHS = (("granite3_2b", "flash_attention", 1), ("mamba2_370m", "ssd_scan", 1),
               ("phi3_mini_38b", "flash_attention", 1), ("gemma3_12b", "flash_attention", 1),
               ("granite_moe_3b_a800m", "flash_attention", 1),
               ("minicpm3_4b", "flash_attention", 1))
#: the mixture-of-experts archs whose smoke configs the LM cross-device
#: phase runs (granite-moe's also serves at full width above; mixtral-8x7b
#: and jamba-1.5-large do not fit the card at full width in float32)
MOE_SMOKE_ARCHS = ("granite_moe_3b_a800m", "mixtral_8x7b", "jamba15_large_398b")
#: archs whose smoke config runs at its published head dim in the LM
#: cross-device phase (D = 96 and 256, the flash instances only they take)
PUBLISHED_HEAD_DIM = ("phi3_mini_38b", "gemma3_12b")
#: archs whose smoke config runs a second time in the LM cross-device phase
#: with the published MLA dims (minicpm3-4b: ranks 768 and 256, qk 64 + 32,
#: v 64 padded to 96, so the card runs the <96> instance; the smoke dims'
#: 24 runs the <64> one)
PUBLISHED_MLA = ("minicpm3_4b",)
#: the models that attend to a memory (ROADMAP A18), served after the
#: others through ``Model.prefill(tokens, memory)`` and ``decode_step``
#: (the engine passes no memory, as the reference's does not): (arch,
#: super-blocks kept, None for all).  seamless-m4t-large-v2 whole (24
#: encoder and 24 decoder layers); llama-3.2-vision-90b at full width, 2 of
#: its 20 super-blocks (10 layers, 2 of them cross-attention: 10.66 B
#: float32 parameters, 42.6 GB; the whole model, 87.67 B, does not fit)
CROSS_SERVE = (("seamless_m4t_large_v2", None), ("llama32_vision_90b", 2))
#: every cross-attention gate's value wherever a cross model runs on the
#: card: a fresh gate is 0, and tanh(0) = 0 would hide cross-attention
CROSS_GATE = 1.0
#: the cross models' prompts: 4 of this many tokens (the request mix's
#: longest prompt, its first batch's length)
CROSS_PROMPT = 1819
SLOTS, MAX_LEN, MAX_NEW, N_REQUESTS, LONG_PROMPT = 4, 4096, 32, 8, 33_000


def allclose(a, b, tol: float):
    """(ok, max |a - b|) for |a - b| <= tol + tol * |b| elementwise, in
    float32: the reference's ``assert_allclose(atol=tol, rtol=tol)``."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return bool((diff <= tol + tol * b.abs()).all()), float(diff.max()) if diff.numel() else 0.0


def flash_tol(dtype) -> float:
    import torch

    return 2e-5 if dtype == torch.float32 else 2e-2


def output_digest(t) -> str:
    """sha256 of a tensor's bytes, to tell whether two runs computed the
    same bits."""
    import torch

    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def flash_kernel_phase(digest_only: bool = False) -> dict:
    """flash_attention kernel vs plain on the card; tolerances of the
    reference's sweep (``tests/test_kernels.py``).  bf16 goes to the
    tensor-core kernel and float32 to the CUDA-core one, so each mask case
    runs in both.  The cases at head dims 16, 64 and 128 come first, from
    their own generator, and each output's sha256 is kept; with
    ``digest_only`` the phase stops after them.  phi3-mini-3.8b's and
    gemma3-12b's head dims (96, 256) follow, from a second generator, then
    granite-moe-3b-a800m's grouping of 24 query heads on 8, then
    cross-attention's calls without the causal mask (seamless-m4t's and
    llama-3.2-vision's layouts)."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    f32, bf16 = torch.float32, torch.bfloat16
    # (B, Hq, Hk, Sq, Sk, D, dtype, kwargs)
    cases = [(1, 4, 4, 256, 256, 64, dt, {"causal": c}) for dt in (f32, bf16)
             for c in (True, False)]
    cases += [(1, 8, 2, 96, 160, 64, dt, {"causal": c}) for dt in (f32, bf16)
              for c in (True, False)]  # lengths the 64-row tiles do not divide
    cases += [(2, 4, 1, 100, 300, 128, dt, {"causal": False}) for dt in (f32, bf16)]
    cases += [(1, 4, hk, 200, 200, 64, dt, {"causal": True, "window": w})
              for hk, w in ((4, 16), (1, 100)) for dt in (f32, bf16)]
    cases += [(1, 4, 2, 200, 200, D, bf16, {"causal": True, "window": w})
              for D in (16, 128) for w in (16, 100)]
    # decode: one query row at q_offset 511
    cases += [(2, 4, 2, 1, 512, D, dt, {"causal": True, "q_offset": 511})
              for D in (16, 64, 128) for dt in (f32, bf16)]
    cases += [(4, 32, 8, 300, 300, 64, bf16, {"causal": True}),   # granite's heads
              (2, 4, 2, 24, 24, 16, f32, {"causal": True}),       # smoke head dim
              (2, 4, 2, 24, 24, 16, bf16, {"causal": True}),
              # Sk not a multiple of the 64-key tile, Sq > Sk, a chunked
              # prefill's offset, a negative scale
              (1, 4, 1, 200, 333, 16, bf16, {"causal": True}),
              (1, 4, 2, 333, 200, 128, bf16, {"causal": False}),
              (1, 4, 2, 70, 333, 64, bf16, {"causal": True, "q_offset": 263}),
              (1, 4, 2, 96, 160, 64, f32, {"causal": True, "sm_scale": -0.1}),
              (1, 4, 2, 96, 160, 64, bf16, {"causal": True, "sm_scale": -0.1})]
    # phi3-mini-3.8b's and gemma3-12b's head dims, in both dtypes: causal
    # and not (MHA), gemma3's 1,024-key window over 1,500 keys with MHA
    # and GQA (n_rep 1 and 2), a decode row at an offset with and without
    # the window, and ragged Sq / Sk (Sq < Sk, Sq > Sk, a chunked prefill's
    # offset; at D = 256, 128-row blocks whose second warpgroup has 6, 72
    # or no rows)
    wide = []
    for D in (96, 256):
        for dt in (f32, bf16):
            wide += [(1, 4, 4, 256, 256, D, dt, {"causal": c}) for c in (True, False)]
            wide += [(1, 8, hk, 1500, 1500, D, dt, {"causal": True, "window": 1024})
                     for hk in (8, 4)]
            wide += [(2, 4, 2, 1, 2048, D, dt, {"causal": True, "q_offset": 2047}),
                     (2, 4, 2, 1, 2048, D, dt, {"causal": True, "window": 1024,
                                                "q_offset": 2047}),
                     (1, 4, 2, 200, 333, D, dt, {"causal": True}),
                     (1, 4, 1, 333, 200, D, dt, {"causal": False}),
                     (1, 4, 2, 70, 333, D, dt, {"causal": True, "q_offset": 263})]
    # granite-moe-3b-a800m's heads, 24 query heads on 8 KV heads (a group
    # of 3, which no other served model has): its first prefill batch's
    # shape on the tensor cores, and a ragged one in float32
    wide += [(4, 24, 8, 1819, 1819, 64, bf16, {"causal": True}),
             (1, 24, 8, 300, 300, 64, f32, {"causal": True})]
    # cross-attention's calls, without the causal mask, in both dtypes, at
    # seamless-m4t's layout (16 heads on 16, D = 64) and llama-3.2-vision's
    # (64 on 8, D = 128): a 1,819-token prompt against the 1,601 patches
    # (25 key tiles of 64 and one of a single key), and decode's one query
    # row (one row of a 64-row tile) against 1,601 and 1,819 keys
    for Hq, Hk, D in ((16, 16, 64), (64, 8, 128)):
        for dt in (f32, bf16):
            wide += [(1, Hq, Hk, 1819, 1601, D, dt, {"causal": False})]
            wide += [(4, Hq, Hk, 1, Sk, D, dt, {"causal": False}) for Sk in (1601, 1819)]
    max_err = {f32: 0.0, bf16: 0.0}
    digests: dict[str, str] = {}

    def run(case, g) -> None:
        B, Hq, Hk, Sq, Sk, D, dt, kw = case
        q = torch.randn((B, Hq, Sq, D), generator=g, device="cuda").to(dt)
        k = torch.randn((B, Hk, Sk, D), generator=g, device="cuda").to(dt)
        v = torch.randn((B, Hk, Sk, D), generator=g, device="cuda").to(dt)
        a = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        label = f"flash_attention B={B} Hq={Hq} Hk={Hk} Sq={Sq} Sk={Sk} D={D} {dt} {kw}"
        digests[label] = output_digest(a)
        b = flash_attention_ref(q, k, v, **kw)
        ok, err = allclose(a, b, flash_tol(dt))
        check(a.dtype == dt and a.shape == q.shape, f"{label}: output {a.dtype} {tuple(a.shape)}")
        check(ok, f"{label}: max |kernel - plain| {err} over tolerance {flash_tol(dt)}")
        max_err[dt] = max(max_err[dt], err)
        log(f"{label}: ok (max |kernel - plain| {err:.3g})")

    # rows with no valid key write 0: a lone decode row past the window,
    # and a tile whose rows 29-63 see no key (qpos 90 + i, window 20, Sk 100)
    # beside rows that do
    def empties(head_dims, g) -> int:
        n = 0
        for D in head_dims:
            for dt in (f32, bf16):
                q = torch.randn((2, 4, 1, D), generator=g, device="cuda").to(dt)
                k = torch.randn((2, 2, 512, D), generator=g, device="cuda").to(dt)
                empty = flash_attention_cuda(q, k, k, causal=False, window=4, q_offset=600)
                check(not bool(empty.any()),
                      f"flash_attention D={D} {dt}: a row with no valid key wrote non-zero")
                q = torch.randn((1, 4, 64, D), generator=g, device="cuda").to(dt)
                k = torch.randn((1, 2, 100, D), generator=g, device="cuda").to(dt)
                kw = {"causal": False, "window": 20, "q_offset": 90}
                a = flash_attention_cuda(q, k, k, **kw)
                digests[f"flash_attention no valid key D={D} {dt}"] = output_digest(a)
                b = flash_attention_ref(q, k, k, **kw)
                check(not bool(a[:, :, 29:].any()) and not bool(b[:, :, 29:].any()),
                      f"flash_attention D={D} {dt}: rows with no valid key beside rows with "
                      f"some wrote non-zero")
                ok, err = allclose(a, b, flash_tol(dt))
                check(ok, f"flash_attention D={D} {dt} {kw}: max |kernel - plain| {err}")
                n += 2
        log(f"flash_attention with no valid key: writes 0 in {n} cases (D = "
            f"{', '.join(map(str, head_dims))}; float32 and bf16), ok")
        return n

    g = torch.Generator(device="cuda").manual_seed(0)
    for case in cases:
        run(case, g)
    n_empty = empties((16, 64), g)
    if digest_only:
        return {"digests": digests}
    g = torch.Generator(device="cuda").manual_seed(2)
    for case in wide:
        run(case, g)
    n_empty += empties((96, 256), g)
    n_padded = padded_head_dim_cases(max_err)
    return {"cases": len(cases) + len(wide) + n_empty + n_padded,
            "max_abs_err_f32": max_err[f32], "max_abs_err_bf16": max_err[bf16]}


def padded_head_dim_cases(max_err: dict) -> int:
    """flash_attention's wrapper at a head dim between the compiled
    instances (24: MLA's in minicpm3-4b's smoke config), which it runs on
    the next instance (64) over zero-padded q, k and v: against the plain
    version at 24, bf16 and float32, causal and windowed; and a head dim
    above every instance raises.  ``max_err`` gains the errors."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(3)
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for kw in ({"causal": True}, {"causal": True, "window": 64},
                   {"causal": True, "q_offset": 511}):
            Sq = 1 if "q_offset" in kw else 200
            q = torch.randn((2, 4, Sq, 24), generator=g, device="cuda").to(dt)
            k = torch.randn((2, 2, 512, 24), generator=g, device="cuda").to(dt)
            v = torch.randn((2, 2, 512, 24), generator=g, device="cuda").to(dt)
            before = ops.LAUNCHES
            a = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            b = flash_attention_ref(q, k, v, **kw)
            ok, err = allclose(a, b, flash_tol(dt))
            label = f"flash_attention D=24 (padded to 64) Sq={Sq} {dt} {kw}"
            check(ops.LAUNCHES == before + 1 and a.dtype == dt and a.shape == q.shape,
                  f"{label}: {ops.LAUNCHES - before} launches, output {tuple(a.shape)}")
            check(ok, f"{label}: max |kernel - plain| {err} over tolerance {flash_tol(dt)}")
            max_err[dt] = max(max_err[dt], err)
            log(f"{label}: ok (max |kernel - plain| {err:.3g})")
            n += 1
    q = torch.zeros((1, 2, 8, 288), device="cuda")
    try:
        ops.flash_attention(q, q, q)
    except ValueError as e:
        check("256" in str(e), f"flash_attention D=288: {e}")
    else:
        check(False, "flash_attention D=288 did not raise")
    log("flash_attention D=288: raises, naming the instances")
    return n + 1


#: edits of ``csrc/flash_attention.cu`` that ``--flash-variants`` builds and
#: times against the shipped source: (old text, new text) pairs
FLASH_VARIANTS = {
    # D = 96 with one warpgroup a block (64-row query tiles)
    "d96_one_warpgroup": [("return D == 96 || D == 256 ? 2 : 1;", "return D == 256 ? 2 : 1;")],
    # the two-warpgroup instances with the next tile's copies issued before
    # S and a barrier closing each key tile, the order of the others
    "early_copies": [("constexpr bool kLate = kWg > 1;", "constexpr bool kLate = false;")],
    # exponentials as one ex2.approx.ftz each, every head dim (a change of
    # numerics the shipped source does not make)
    "ex2_approx": [
        ("    alpha[r] = exp2f(m[r] - mx[r]);",
         '    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(alpha[r]) : "f"(m[r] - mx[r]));'),
        ("    float e = exp2f(s[i] - mx[(i >> 1) & 1]);",
         '    float e;\n'
         '    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(s[i] - mx[(i >> 1) & 1]));')],
}
#: (label, B, Hq, Hk, S, D, window): the serving path's first prefill
#: batch of each model (causal, bf16)
FLASH_VARIANT_SHAPES = [("granite3_2b", 4, 32, 8, 1819, 64, None),
                        ("phi3_mini_38b", 4, 32, 32, 1819, 96, None),
                        ("gemma3_12b/full", 4, 16, 8, 1819, 256, None),
                        ("gemma3_12b/window", 4, 16, 8, 1819, 256, 1024)]


def flash_variant_library(name: str, edits) -> ctypes.CDLL:
    """``csrc/flash_attention.cu`` with ``edits`` applied, built with the
    port's own flags beside its libraries."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        check(old in src, f"flash variant {name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"flash_attention_{name}.cu"
    path.write_text(src)
    lib = path.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def flash_variants_phase() -> dict:
    """Each variant's kernel against the plain version, then timed in turns
    with the shipped one (shipped, variant, variant, shipped) by CUDA
    events at :data:`FLASH_VARIANT_SHAPES`."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    shipped = _build.load("flash_attention")
    with concurrent.futures.ThreadPoolExecutor(len(FLASH_VARIANTS)) as pool:
        libs = dict(zip(FLASH_VARIANTS, pool.map(lambda kv: flash_variant_library(*kv),
                                                 FLASH_VARIANTS.items())))
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for label, B, Hq, Hk, S, D, window in FLASH_VARIANT_SHAPES:
        q = torch.randn((B, Hq, S, D), generator=g, device="cuda").bfloat16()
        k = torch.randn((B, Hk, S, D), generator=g, device="cuda").bfloat16()
        v = torch.randn((B, Hk, S, D), generator=g, device="cuda").bfloat16()
        ref = flash_attention_ref(q, k, v, causal=True, window=window)
        times = {}

        def with_lib(lib):
            _build._loaded["flash_attention"] = lib
            return cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True, window=window))

        try:
            for name, lib in libs.items():
                _build._loaded["flash_attention"] = lib
                o = flash_attention_cuda(q, k, v, causal=True, window=window)
                ok, err = allclose(o, ref, flash_tol(torch.bfloat16))
                check(ok, f"flash variant {name} at {label}: max |kernel - plain| {err}")
                s1, v1, v2, s2 = (with_lib(x) for x in (shipped, lib, lib, shipped))
                times[name] = {"ms": min(v1, v2), "shipped_ms": min(s1, s2),
                               "runs": [s1, v1, v2, s2]}
        finally:
            _build._loaded["flash_attention"] = shipped
        out[label] = times
        log(f"flash variants at {label}'s prefill shape {[B, Hq, Hk, S, D, window]}: "
            + "; ".join(f"{n} {t['ms']:.4f} ms against shipped {t['shipped_ms']:.4f} "
                        f"(turns {' / '.join(f'{x:.4f}' for x in t['runs'])})"
                        for n, t in times.items()))
        del q, k, v, ref
    return out


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, in float32."""
    return float((a.float() - b.float()).abs().max()) / (float(b.float().abs().max()) + 1e-9)


#: ssd_scan's sweep, (BH, BG, L, P, N): L = 1, under one chunk, ragged;
#: mamba2-370m's widths (one group for 32 heads) and its smoke; jamba-1.5's
#: full widths (P = N = 128, 8 groups) at the first serving batch's length
#: and its smoke (2 groups); more heads and groups than a grid's y axis
#: holds (65,535)
SSD_CASES = [(4, 4, 1, 64, 128), (8, 2, 40, 64, 128), (32, 1, 100, 64, 128),
             (32, 1, 2048, 64, 128), (4, 4, 2048, 64, 128), (8, 8, 100, 16, 16),
             (16, 8, 1819, 128, 128), (4, 2, 100, 16, 16), (70_000, 70_000, 80, 4, 4)]


def ssd_kernel_phase() -> dict:
    """ssd_scan kernels vs the plain per-step recurrence on the card: max
    error below 3e-4 of max|y| (the reference's float32 bound); and vs the
    plain version of the kernels' own passes at their chunk
    (``ssd_scan_state_passing``): y to the same bound, and the states the
    state pass leaves (the state entering each chunk past the first) within
    1e-5."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_state_passing
    from repro_torch.kernels.ssd_scan.ssd_scan import chunk, plan

    cases = SSD_CASES
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = worst_states = max_abs = 0.0
    for BH, BG, L, P, N in cases:
        xdt = torch.randn((BH, L, P), generator=g, device="cuda") * 0.5
        dtA = -(0.01 + 0.49 * torch.rand((BH, L), generator=g, device="cuda"))
        B = torch.randn((BG, L, N), generator=g, device="cuda") * 0.3
        C = torch.randn((BG, L, N), generator=g, device="cuda") * 0.3
        call = plan(xdt, dtA, B, C, BH // BG)
        for _, launch in call.passes:
            launch()
        torch.cuda.synchronize()
        a = call.y
        b = ssd_scan_ref(xdt, dtA, B, C, BH // BG)
        y_sp, s_in = ssd_scan_state_passing(xdt, dtA, B, C, BH // BG, chunk(),
                                            return_states=True)
        err, err_sp = rel_err(a, b), rel_err(a, y_sp)
        err_states = (float((call.states - s_in[:, 1:]).abs().max())
                      if call.states.numel() else 0.0)
        label = f"ssd_scan BH={BH} BG={BG} L={L} P={P} N={N} (chunk {chunk()})"
        check(err < 3e-4, f"{label}: error {err} of max|y| against the recurrence, over 3e-4")
        check(err_sp < 3e-4, f"{label}: error {err_sp} of max|y| against the plain passes")
        check(err_states < 1e-5, f"{label}: passed states off by {err_states}, over 1e-5")
        worst = max(worst, err, err_sp)
        worst_states = max(worst_states, err_states)
        max_abs = max(max_abs, float((a - b).abs().max()))
        log(f"{label}: ok (max error {err:.3g} of max|y| against the recurrence, {err_sp:.3g} "
            f"against the plain passes; passed states {err_states:.3g})")
    return {"cases": len(cases), "max_rel_err": worst, "max_abs_err": max_abs,
            "max_abs_err_states": worst_states}


def expected_verdict(tier: int, plen: int, req: int, temp: float, depth: int):
    """The admission rules of ``serve/admission.py`` written out in Python:
    an independent check of what the Froid-compiled plan decided on the
    card.  Returns (admit, granted tokens, effective temperature)."""
    admit = plen <= 32768 and not (depth > 512 and plen > 8192)
    cap = 4096 if tier >= 2 else 1024 if tier == 1 else 256
    if plen > 2048:
        cap //= 2
    granted = req if req < cap else cap
    if temp < 0.0 or temp > 2.0:
        t = 0.7
    elif tier == 0:
        t = 1.0 if temp > 1.0 else temp
    else:
        t = temp
    return admit, granted, t


def serve_requests(vocab: int):
    """8 requests with 512-2048-token prompts (numpy seed 0), temperatures
    0.0, 0.7 and 1.0 in turn, tiers 0-2, and a 9th whose 33,000-token
    prompt the ``admit`` rule rejects."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(512, 2049, N_REQUESTS)
    tiers = rng.integers(0, 3, N_REQUESTS + 1)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=MAX_NEW, temperature=(0.0, 0.7, 1.0)[i % 3],
                    tier=int(tiers[i]))
            for i, n in enumerate(lens)]
    reqs.append(Request(rid=N_REQUESTS,
                        prompt=rng.integers(0, vocab, LONG_PROMPT).astype(np.int32),
                        max_new_tokens=MAX_NEW, temperature=0.0,
                        tier=int(tiers[N_REQUESTS])))
    return reqs


class TimedModel:
    """The model as the engine sees it, each prefill and decode step timed
    on the host clock around work that ends in ``torch.cuda.synchronize``,
    and its logits checked finite."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.prefill_ms: list[float] = []
        self.decode_ms: list[float] = []
        self.finite = True

    def _timed(self, fn, sink, *args, **kwargs):
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t) * 1e3)
        self.finite &= bool(torch.isfinite(logits).all())
        return logits, cache

    def prefill(self, tokens, max_len=None):
        return self._timed(self.model.prefill, self.prefill_ms, tokens, max_len=max_len)

    def decode_step(self, cache, tokens):
        return self._timed(self.model.decode_step, self.decode_ms, cache, tokens)


class LongestCall:
    """Wraps a kernel binding: passes every call through, counts the calls
    of each kind and keeps, for each kind, the arguments of the one with
    the longest sequence (dim 1 of the first argument for ssd_scan's
    (BH, L, P), dim 2 for attention's q).  Kinds: ``kind_of(args, kwargs)``
    where given, else ``"window"`` for an attention call with a window
    (gemma3's local layers) and ``"full"`` for the rest."""

    def __init__(self, fn, seq_dim: int, kind_of=None):
        self.fn, self.seq_dim, self.kind_of = fn, seq_dim, kind_of
        self.calls: dict[str, tuple] = {}
        self.counts: dict[str, int] = {}

    def __call__(self, *args, **kwargs):
        kind = (self.kind_of(args, kwargs) if self.kind_of is not None
                else "window" if kwargs.get("window") is not None else "full")
        self.counts[kind] = self.counts.get(kind, 0) + 1
        kept = self.calls.get(kind)
        if kept is None or args[0].shape[self.seq_dim] > kept[0][0].shape[self.seq_dim]:
            self.calls[kind] = (args, kwargs)
        return self.fn(*args, **kwargs)


def device_busy(fn, host: bool = True,
                annotation: str | None = None) -> tuple[float | None, list, dict, int]:
    """Device time (ms) of what ``fn`` runs on the card, as the union of the
    intervals of the device events (kernels, copies) in a ``torch.profiler``
    trace, the five kernels with the most device time, and the port's own
    kernels by name (``flash_fwd_bf16``, ``flash_fwd_kernel``, ...) with
    their time and launches, a template instance also by its last integer
    argument (``flash_fwd_bf16<96>``, the head dim), and the number of
    device events.  (None, [], {}, 0) if the trace holds no device event.
    ``host=False`` records no host operators, which keeps the profiler's own
    host cost down over a long ``fn``.  With ``annotation``, the name of
    ``torch.profiler.record_function`` ranges that ``fn`` opens, the third
    item also holds ``annotation``: the device time of the kernels launched
    inside those ranges (ms) and their number (the ranges themselves are
    not device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name != annotation)
    if not spans:
        return None, [], {}, 0
    busy, end, by_name, port = 0.0, float("-inf"), {}, {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        m = re.search(r"(flash_(?:fwd|bwd)_\w+|ssd_\w+|relagg_\w+)(<[^>]*>)?", name)
        if m:
            arg = re.findall(r"\d+", m.group(2) or "")
            for key in [m.group(1)] + ([f"{m.group(1)}<{arg[-1]}>"] if arg else []):
                entry = port.setdefault(key, {"ms": 0.0, "launches": 0})
                entry["ms"] += (b - a) / 1e3
                entry["launches"] += 1
    if annotation is not None:
        ranges = [e for e in prof.events()
                  if e.name == annotation and e.device_type == DeviceType.CPU]
        port[annotation] = {"ms": sum(e.device_time_total for e in ranges) / 1e3,
                            "launches": len(ranges)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return busy / 1e3, [(name[:60], ms / 1e3) for name, ms in top], port, len(spans)


def busy_breakdown(model, reqs, expected) -> dict:
    """Device busy time of one prefill at the first batch's shape (the
    trace with more device events of two) and of 4 decode steps after it
    (profiled apart from the timed runs, whose host clock the profiler
    would inflate).  For a model with MoE layers, also the device time of
    the kernels launched inside them in the traced prefill (each ``moe``
    call inside a ``record_function("moe")`` range) and its share of the
    prefill's busy time."""
    import torch

    from repro_torch.models import transformer as T

    batch = [r for r in reqs if expected[r.rid][0]][:SLOTS]
    S = max(len(r.prompt) for r in batch)
    toks = np.zeros((len(batch), S), np.int32)
    for i, r in enumerate(batch):
        toks[i, S - len(r.prompt):] = r.prompt
    toks = torch.as_tensor(toks, device="cuda")
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(toks, max_len=MAX_LEN)

    def decode():
        for _ in range(4):
            nxt = state["logits"].argmax(-1).to(torch.int32)[:, None]
            state["logits"], state["cache"] = model.decode_step(state["cache"], nxt)

    cfg = model.cfg
    moe_layers = cfg.n_repeats * sum(spec.mlp == "moe" for spec in cfg.super_block)
    has_moe = moe_layers > 0
    annotation = "moe" if has_moe else None
    moe = T.moe

    def annotated_moe(*args, **kwargs):
        with torch.profiler.record_function("moe"):
            return moe(*args, **kwargs)

    prefill()  # warm
    # a trace now and then loses a device event (a flash kernel of
    # gemma3-12b's prefill, in a full run of this script) and never adds
    # one: the readings and the checks on the prefill's kernels take the
    # more complete of two traces of it
    if has_moe:
        T.moe = annotated_moe
    try:
        p_ms, p_top, p_port, _ = max((device_busy(prefill, annotation=annotation)
                                      for _ in range(2)), key=lambda r: r[3])
    finally:
        T.moe = moe
    d_ms, d_top, _, _ = device_busy(decode)
    del state
    out = {"prefill_busy_ms": p_ms, "prefill_top": p_top, "prefill_port_kernels": p_port,
           "decode_busy_ms_per_step": None if d_ms is None else d_ms / 4,
           "decode_top": d_top}
    if has_moe and p_ms is not None:
        layers = p_port.pop("moe")
        check(layers["launches"] == moe_layers and layers["ms"] > 0,
              f"{cfg.name} prefill: {layers['launches']} traced moe ranges with "
              f"{layers['ms']:.3f} ms of kernels, expected {moe_layers} with some")
        out.update(prefill_moe_ms=layers["ms"], prefill_moe_share=layers["ms"] / p_ms)
    return out


def serving_phase(arch: str, kernel: str, n_runs: int) -> tuple[dict, LongestCall]:
    """Serve the requests with ``arch`` at its published widths and depths
    on the card, ``n_runs`` times.  Returns the summary and the capture of
    the first run's kernel calls (:class:`LongestCall`)."""
    import torch

    from repro_torch.configs import config_for
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_binding
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = config_for(arch)
    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params:,} "
        f"float32 parameters ({n_params * 4 / 1e9:.2f} GB) initialised on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    reqs = serve_requests(cfg.vocab)
    depth = len(reqs)
    expected = {r.rid: expected_verdict(r.tier, len(r.prompt), r.max_new_tokens,
                                        r.temperature, depth) for r in reqs}
    n_batches = math.ceil(sum(v[0] for v in expected.values()) / SLOTS)
    counters = {"flash_attention": fa_ops, "ssd_scan": ssd_ops}
    # the binding modules (each package's name of the same spelling is its
    # ops function)
    binding = importlib.import_module(f"repro_torch.kernels.{kernel}.{kernel}")
    attr, seq_dim = (("flash_attention_cuda", 2) if kernel == "flash_attention"
                     else ("ssd_scan_cuda", 1))

    runs = []
    capture = None
    for i in range(n_runs):
        timed = TimedModel(model)
        engine = ServeEngine(timed, slots=SLOTS, max_len=MAX_LEN, seed=0)
        if i == 0:
            capture = LongestCall(getattr(binding, attr), seq_dim)
            setattr(binding, attr, capture)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for ops in counters.values():
            ops.LAUNCHES = 0  # counts from here to the end of this run only
        t = time.perf_counter()
        try:
            done = engine.run(reqs)
            torch.cuda.synchronize()
        finally:
            if i == 0:
                setattr(binding, attr, capture.fn)
        wall = time.perf_counter() - t
        launches = {name: ops.LAUNCHES for name, ops in counters.items()}
        runs.append({"done": {c.rid: c for c in done}, "wall_s": wall, "launches": launches,
                     "peak_bytes": torch.cuda.max_memory_allocated(), "timed": timed})

    first, later = runs[0], runs[1:]
    second = later[0] if later else None
    # the online intake on the first model only (granite-3-2b)
    intake = intake_check(model, reqs, first["done"]) if arch == SERVE_ARCHS[0][0] else None
    for rid, (admit, granted, _) in expected.items():
        c = first["done"][rid]
        if not admit:
            check(c.reason == "rejected" and not c.tokens,
                  f"{arch} request {rid}: {c.reason}, expected rejected")
            continue
        check(c.reason == "length" and len(c.tokens) == granted,
              f"{arch} request {rid}: {c.reason} with {len(c.tokens)} tokens, "
              f"expected length with {granted}")
        check(all(0 <= t < cfg.vocab for t in c.tokens), f"{arch} request {rid}: bad token id")
        same = all(c.tokens == run["done"][rid].tokens for run in later)
        kind = "greedy" if reqs[rid].temperature == 0.0 else "sampled"
        check(same, f"{arch} request {rid} ({kind}): tokens differ between two runs")
    for run in runs:
        check(run["timed"].finite, f"{arch}: non-finite logits")
        want = {name: cfg.n_layers * n_batches if name == kernel else 0 for name in counters}
        check(run["launches"] == want, f"{arch}: kernel launches {run['launches']}, "
              f"expected {want} ({cfg.n_layers} layers x {n_batches} prefill batches)")
        check(len(run["timed"].prefill_ms) == n_batches, f"{arch}: prefill batches")
    check(sum(capture.counts.values()) == first["launches"][kernel],
          f"{arch}: binding calls by kind {capture.counts}, "
          f"{first['launches'][kernel]} launches counted")
    generated = sum(len(c.tokens) for c in first["done"].values())
    timed = first["timed"]
    busy = busy_breakdown(model, reqs, expected)
    port = busy["prefill_port_kernels"]
    if kernel == "flash_attention" and busy["prefill_busy_ms"] is not None:
        # the bf16 activations reach the tensor-core kernel, never the
        # CUDA-core one: one launch per layer in the traced prefill
        check("flash_fwd_kernel" not in port
              and port.get("flash_fwd_bf16", {}).get("launches") == cfg.n_layers,
              f"{arch} prefill: port kernels in the trace {port}, expected "
              f"flash_fwd_bf16 x {cfg.n_layers} and no flash_fwd_kernel")
        # and at the model's head dim, no other instance
        flash = {name: entry["launches"] for name, entry in port.items()
                 if name.startswith("flash_fwd") and "<" in name}
        want = {f"flash_fwd_bf16<{cfg.head_dim}>": cfg.n_layers}
        check(flash == want, f"{arch} prefill: flash instances in the trace {flash}, "
              f"expected {want} and nothing else")
    if kernel == "ssd_scan" and busy["prefill_busy_ms"] is not None:
        # the four passes once a layer each, C B^T (ssd_chunk_cb) included:
        # once per group and chunk within its launch, not once per head;
        # and no kernel of the earlier design (ssd_scan_kernel)
        ssd = {name: entry["launches"] for name, entry in port.items()
               if name.startswith("ssd_")}
        check(ssd == dict.fromkeys(ssd_binding.PASSES, cfg.n_layers),
              f"{arch} prefill: ssd kernels in the trace {ssd}, expected each of "
              f"{list(ssd_binding.PASSES)} x {cfg.n_layers} and nothing else")
    summary = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "requests": len(reqs), "rejected": sum(not v[0] for v in expected.values()),
        "prompt_lens": [len(r.prompt) for r in reqs], "prefill_batches": n_batches,
        "runs": n_runs, "prefill_ms": timed.prefill_ms,
        "prefill_ms_2nd_run": second and second["timed"].prefill_ms,
        "decode_ms_per_token": float(np.mean(timed.decode_ms)),
        "decode_ms_per_token_2nd_run": second and float(np.mean(second["timed"].decode_ms)),
        "generated_tokens": generated, "wall_s": first["wall_s"],
        "wall_s_2nd_run": second and second["wall_s"],
        "tokens_per_s": generated / first["wall_s"],
        "peak_gb": first["peak_bytes"] / 1e9, "launches": first["launches"][kernel],
        "intake": intake, **busy,
    }
    for what, wall in (("prefill", timed.prefill_ms[0]),
                       ("decode", summary["decode_ms_per_token"])):
        ms = busy[f"{what}_busy_ms" if what == "prefill" else "decode_busy_ms_per_step"]
        summary[f"{what}_device_idle_share"] = None if ms is None else 1.0 - ms / wall
        log(f"{cfg.name} {what}: device busy "
            + ("not measured (no device events in the trace)" if ms is None else
               f"{ms:.2f} ms of {wall:.2f} ms (idle share {1.0 - ms / wall:.3f}); top "
               f"{[(n, round(t, 2)) for n, t in busy[what + '_top']]}"
               + (f"; port kernels {port}" if what == "prefill" else "")
               + (f"; MoE layers {busy['prefill_moe_ms']:.2f} ms, a share of "
                  f"{busy['prefill_moe_share']:.3f}"
                  if what == "prefill" and "prefill_moe_ms" in busy else "")))
    walls = " s and ".join(f"{run['wall_s']:.2f}" for run in runs)
    log(f"{cfg.name}: served {len(reqs)} requests ({summary['rejected']} rejected by "
        f"admission, {generated} tokens) in {walls} s; prefill ms per batch "
        f"{[round(x, 1) for x in timed.prefill_ms]}, "
        f"decode {summary['decode_ms_per_token']:.2f} ms/token, "
        f"{summary['tokens_per_s']:.1f} tokens/s, peak {summary['peak_gb']:.2f} GB; "
        f"{kernel} launches {first['launches'][kernel]} per run ({capture.counts})"
        + (f"; greedy and sampled tokens equal across the {n_runs} runs" if later else "")
        + (f"; submit/drain == run (admission through the scheduler, {intake['wall_s']:.2f} s)"
           if intake else ""))
    del model, engine, runs, first, later, second, timed
    gc.collect()
    torch.cuda.empty_cache()
    return summary, capture


def set_gates(tree, value: float = CROSS_GATE) -> None:
    """Every ``gate`` leaf of a parameter tree (dicts and lists of
    tensors) set to ``value`` in place."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            if key == "gate":
                v.fill_(value)
            else:
                set_gates(v, value)
    elif isinstance(tree, list):
        for v in tree:
            set_gates(v, value)


def cross_layer_counts(cfg) -> dict[str, int]:
    """A model's flash calls by kind in one prefill: the encoder's layers
    (no causal mask), the decoder's self-attention layers (causal), and the
    layers that attend to the memory (the ``cross`` mixer or a
    ``cross_memory`` sublayer; no causal mask), each once a super-block."""
    per = {"self": sum(s.mixer == "attn" for s in cfg.super_block),
           "cross": sum(s.mixer == "cross" or s.cross_memory for s in cfg.super_block)}
    counts = {"encoder": cfg.n_encoder_layers, **{k: n * cfg.n_repeats for k, n in per.items()}}
    return {k: n for k, n in counts.items() if n}


def cross_kinds():
    """A ``kind_of`` for :class:`LongestCall` over a cross model's flash
    calls: ``"decode_cross"`` for one query row, ``"self"`` under the causal
    mask, and without it ``"encoder"`` before the first causal call of the
    run (the encoder runs first) and ``"cross"`` after."""
    seen = {"causal": False}

    def kind_of(args, kwargs) -> str:
        if args[0].shape[2] == 1:
            return "decode_cross"
        if kwargs.get("causal", True):
            seen["causal"] = True
            return "self"
        return "cross" if seen["causal"] else "encoder"

    return kind_of


def cross_serving_phase(arch: str, repeats, device: str = "cuda", config=None,
                        prompt: int = CROSS_PROMPT) -> tuple[dict, LongestCall]:
    """Serve ``arch`` (a model that attends to a memory) at full width on
    the card, its depth cut to ``repeats`` super-blocks where given, every
    gate at :data:`CROSS_GATE`: one prefill of 4 x ``prompt`` tokens with
    the memory (vision patches or audio frames as long as the
    prompt, unit normal), both from numpy seed 0, then ``MAX_NEW - 1``
    greedy decode steps.  flash_attention's launches counted over that run
    (prefill: the encoder's, the self-attention's and the cross layers';
    each decode step: the cross layers' only); a traced prefill's and a
    traced decode step's port kernels checked by name and count; a memory
    drawn from seed 1 must move the prefill's logits.  A warm prefill is
    timed after the run (the run's own is the model's first, cold: its
    shapes are new to cuBLAS).  Returns the summary
    and the capture of the run's flash calls by kind (:func:`cross_kinds`).
    ``device="cpu"`` with a smoke ``config`` rehearses it on the CPU
    (untimed, no trace)."""
    import dataclasses

    import torch

    from repro_torch.configs import config_for
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model

    full = config or config_for(arch)
    cfg = full if repeats is None else dataclasses.replace(full, n_repeats=repeats)
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = build_model(cfg, device)
    tree = model.init_params(torch.Generator(device).manual_seed(0))
    set_gates(tree)
    model.load(tree)
    del tree
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    cut = "" if repeats is None else f" ({repeats} of {full.n_repeats} super-blocks)"
    log(f"{cfg.name}{cut}: {cfg.n_layers} decoder layers, {cfg.n_encoder_layers} encoder "
        f"layers, d_model {cfg.d_model}, head dim {cfg.head_dim}, {n_params:,} float32 "
        f"parameters ({n_params * 4 / 1e9:.2f} GB) initialised on {device} in "
        f"{time.perf_counter() - t0:.1f} s, gates at {CROSS_GATE}")
    M = cfg.vision_tokens or prompt

    def inputs(seed: int):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab, (SLOTS, prompt)).astype(np.int32)
        memory = rng.standard_normal((SLOTS, M, cfg.d_model), dtype=np.float32)
        return (torch.as_tensor(toks, device=device),
                torch.as_tensor(memory, device=device).to(torch.bfloat16))

    toks, memory = inputs(0)
    per = cross_layer_counts(cfg)
    binding = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    capture = LongestCall(binding.flash_attention_cuda, 2, kind_of=cross_kinds())
    state = {}

    def prefill(mem=memory):
        state["logits"], state["cache"] = model.prefill(toks, mem, max_len=MAX_LEN)

    def decode():
        nxt = state["logits"].argmax(-1).to(torch.int32)[:, None]
        state["logits"], state["cache"] = model.decode_step(state["cache"], nxt)
        return nxt

    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES = 0  # counts from here to the end of this run only
    binding.flash_attention_cuda = capture
    generated, finite, decode_ms = [], True, []
    try:
        t = time.perf_counter()
        prefill()
        sync()
        prefill_ms = (time.perf_counter() - t) * 1e3
        finite &= bool(torch.isfinite(state["logits"]).all())
        first_logits = state["logits"].float()
        for _ in range(MAX_NEW - 1):
            t = time.perf_counter()
            generated.append(decode())
            sync()
            decode_ms.append((time.perf_counter() - t) * 1e3)
            finite &= bool(torch.isfinite(state["logits"]).all())
        generated.append(state["logits"].argmax(-1).to(torch.int32)[:, None])
    finally:
        binding.flash_attention_cuda = capture.fn
    launches = fa_ops.LAUNCHES
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tokens = torch.cat(generated, dim=1).cpu()
    check(finite, f"{cfg.name}: non-finite logits")
    check(tokens.shape == (SLOTS, MAX_NEW) and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          f"{cfg.name}: generated tokens {tuple(tokens.shape)} out of the vocabulary")
    want = {**per, "decode_cross": per["cross"] * (MAX_NEW - 1)}
    check(capture.counts == want, f"{cfg.name}: flash calls by kind {capture.counts}, "
          f"expected {want}")
    check(launches == sum(want.values()), f"{cfg.name}: flash launches {launches}, "
          f"expected {sum(want.values())} ({want})")
    # the memory reaches the logits: another memory, other logits
    _, other = inputs(1)
    prefill(other)
    moved = float((state["logits"].float() - first_logits).abs().max())
    check(moved > 0.0, f"{cfg.name}: a memory drawn from another seed left the logits as "
          f"they were")
    del other
    # a warm prefill, timed; then traces (device events only): a prefill
    # (the more complete of two) and one decode step
    sync()
    t = time.perf_counter()
    prefill()
    sync()
    prefill_warm_ms = (time.perf_counter() - t) * 1e3
    p_ms, p_top, p_port, d_ms, d_top, d_port = None, [], {}, None, [], {}
    if on_card:
        p_ms, p_top, p_port, _ = max((device_busy(prefill, host=False) for _ in range(2)),
                                     key=lambda r: r[3])
        d_ms, d_top, d_port, _ = device_busy(decode, host=False)
    n_prefill = sum(per.values())
    if p_ms is not None:
        flash = {name: e["launches"] for name, e in p_port.items()
                 if name.startswith("flash_fwd") and "<" in name}
        want_p = {f"flash_fwd_bf16<{cfg.head_dim}>": n_prefill}
        check(flash == want_p and "flash_fwd_kernel" not in p_port,
              f"{cfg.name} prefill: flash instances in the trace {flash}, expected {want_p} "
              f"and no flash_fwd_kernel")
    if d_ms is not None:
        got = d_port.get(f"flash_fwd_bf16<{cfg.head_dim}>", {}).get("launches", 0)
        check(got == per["cross"] and "flash_fwd_kernel" not in d_port,
              f"{cfg.name} decode step: flash_fwd_bf16<{cfg.head_dim}> x {got} in the trace, "
              f"expected {per['cross']} (the cross layers, one query row each)")
    del state
    decode_mean = float(np.mean(decode_ms))
    wall_ms = prefill_ms + sum(decode_ms)
    summary = {
        "arch": cfg.name, "layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers,
        "super_blocks": cfg.n_repeats, "super_blocks_published": full.n_repeats,
        "params": n_params, "batch": SLOTS, "prompt": prompt, "memory_len": M,
        "gate": CROSS_GATE, "prefill_ms": prefill_ms, "prefill_warm_ms": prefill_warm_ms,
        "decode_ms_per_step": decode_mean,
        "decode_ms": decode_ms, "generated_tokens": SLOTS * MAX_NEW,
        "tokens_per_s": SLOTS * MAX_NEW / (wall_ms / 1e3), "peak_gb": peak / 1e9,
        "launches": launches, "launches_by_kind": dict(capture.counts),
        "memory_moves_logits": moved / float(first_logits.abs().max()),
        "prefill_busy_ms": p_ms, "prefill_top": p_top, "prefill_port_kernels": p_port,
        "decode_busy_ms_per_step": d_ms, "decode_top": d_top, "decode_port_kernels": d_port,
        "prefill_device_idle_share": None if p_ms is None else 1.0 - p_ms / prefill_warm_ms,
        "decode_device_idle_share": None if d_ms is None else 1.0 - d_ms / decode_mean,
    }
    log(f"{cfg.name}{cut}: prefill of {SLOTS} x {prompt} tokens over a memory of {M} "
        f"{prefill_ms:.1f} ms, warm {prefill_warm_ms:.1f} ms (traced busy "
        + ("not measured" if p_ms is None else f"{p_ms:.2f} ms; port kernels {p_port}")
        + f"), decode {decode_mean:.2f} ms a step (traced busy "
        + ("not measured" if d_ms is None else f"{d_ms:.2f} ms; port kernels {d_port}")
        + f"), {summary['tokens_per_s']:.1f} tokens/s, peak {summary['peak_gb']:.2f} GB; "
        f"flash launches {launches} ({dict(capture.counts)}); a memory from seed 1 moves "
        f"the prefill's logits by {summary['memory_moves_logits']:.3g} x max|logit|")
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return summary, capture


def valid_pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int) -> int:
    """(query, key) pairs the attention mask lets through, per (b, head)."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window is not None else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(B: int, Hq: int, Hk: int, Sq: int, Sk: int, D: int, itemsize: int,
                causal: bool = True, window=None, q_offset: int = 0) -> dict:
    """The least time the card could take for one flash_attention call: 4 D
    operations per (query, key) pair the mask lets through at the bf16
    tensor-core peak, against q, k, v and o moved once each (K and V once
    for the n_rep query heads that share them) at the HBM rate; the larger
    of the two, and which it is."""
    pairs = valid_pairs(Sq, Sk, causal, window, q_offset) * B * Hq
    ops_count = 4 * D * pairs
    nbytes = (2 * B * Hq * Sq * D + 2 * B * Hk * Sk * D) * itemsize
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / BF16_OPS_PER_S * 1e3
    return {"pairs": pairs, "ops": ops_count, "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


#: the bf16 kernel against the plain version computed in float32 on the
#: same bf16 inputs: mean |diff| at most this share of mean |plain|.  The
#: kernel's bf16 output alone rounds by ~0.0014 of |o| on average (half an
#: ulp of 8 bits, uniformly spread); P is rounded to bf16 once more before
#: the value product.  A dropped 64-key tile must read above the limit over
#: the rows that tile reaches (and, at granite-3-2b's layer, where this
#: check began, over all rows as well).
FLASH_MEAN_LIMIT = 0.004


def plain_f32_without(q, k, v, kw, keys: range):
    """The plain version's arithmetic (``ref.flash_attention_ref``) in
    float32 on q, k, v with ``keys`` masked out as well: what a kernel that
    skipped those keys would give.  One batch row at a time, to keep the
    (Hq, Sq, Sk) scores small."""
    import torch

    from repro_torch.kernels.flash_attention.ref import _mask

    B, Hq, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    scale = D ** -0.5 if kw.get("sm_scale") is None else kw["sm_scale"]
    mask = _mask(Sq, Sk, kw.get("causal", True), kw.get("window"), kw.get("q_offset", 0),
                 q.device)
    mask[:, keys.start:keys.stop] = False
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        kb = k[b].float().repeat_interleave(Hq // Hk, 0)
        vb = v[b].float().repeat_interleave(Hq // Hk, 0)
        s = torch.einsum("hqd,hkd->hqk", q[b].float(), kb) * scale
        s = torch.where(mask, s, float("-inf"))
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        den = p.sum(-1, keepdim=True)
        out[b] = torch.einsum("hqk,hkd->hqd", p / torch.where(den > 0, den, 1.0), vb)
        del s, p
    return out


def time_flash(args, all_rows_control: bool = True) -> dict:
    """flash_attention on the serving path's own inputs: checked against the
    plain version, timed beside it, beside ``scaled_dot_product_attention``
    (with the window as a boolean mask where there is one; without the
    causal mask where the call has none) and beside the bound of this data
    (:func:`flash_bound`).  In bf16 the
    kernel is also held by mean |diff| to the plain version in float32
    (:data:`FLASH_MEAN_LIMIT`), over all rows and over the rows that the
    middle 64-key tile reaches, beside the same measure of the plain version
    with that tile left out (the control, which must read above the limit
    over those rows, and with ``all_rows_control`` over all rows as well:
    over all rows it is diluted by the rows the tile never reaches) and of
    SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import _mask, flash_attention_ref

    (q, k, v), kw = args
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    causal, window = kw.get("causal", True), kw.get("window")
    q_offset = kw.get("q_offset", 0)
    out = flash_attention_cuda(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    ok, err = allclose(out, ref, flash_tol(q.dtype))
    check(ok, f"flash_attention at the serving inputs: max |kernel - plain| {err}")
    sdpa_ok = (q_offset == 0 and kw.get("sm_scale") is None
               and (Sq == Sk or not causal) and (window is None or causal))
    # the causal window as SDPA's boolean mask (True: attend); every row
    # keeps its own key, so no row is empty
    window_mask = None if window is None else _mask(Sq, Sk, True, window, 0, q.device)

    def library():
        if window_mask is not None:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=window_mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    lib_err = float((library().float() - ref.float()).abs().max()) if sdpa_ok else None
    del ref
    # the same inputs in float32, for the CUDA-core kernel, where the
    # tolerance is tight enough to see a masking or tile-skipping error at
    # the path's own length
    q32, k32, v32 = q.float(), k.float(), v.float()
    ref32 = flash_attention_ref(q32, k32, v32, **kw)
    ok32, err32 = allclose(flash_attention_cuda(q32, k32, v32, **kw), ref32,
                           flash_tol(torch.float32))
    check(ok32, f"flash_attention at the serving inputs in float32: max |kernel - plain| "
          f"{err32} over tolerance {flash_tol(torch.float32)}")
    # the bf16 kernel against that float32 plain version, by mean |diff|
    mean_plain = float(ref32.abs().mean())
    limit = FLASH_MEAN_LIMIT * mean_plain
    mean_diff = float((out.float() - ref32).abs().mean())
    tile = (Sk // 64) // 2
    keys = range(64 * tile, 64 * tile + 64)
    without = plain_f32_without(q32, k32, v32, kw, keys)
    control = float((without - ref32).abs().mean())
    # the rows whose valid keys include some of that tile
    reach = _mask(Sq, Sk, causal, window, q_offset, q.device)[:, keys.start:keys.stop].any(1)
    limit_r = FLASH_MEAN_LIMIT * float(ref32[:, :, reach].abs().mean())
    mean_diff_r = float((out.float() - ref32)[:, :, reach].abs().mean())
    control_r = float((without - ref32)[:, :, reach].abs().mean())
    sdpa_mean = float((library().float() - ref32).abs().mean()) if sdpa_ok else None
    del q32, k32, v32, ref32, out, without
    check(mean_diff <= limit, f"flash_attention bf16 at the serving inputs: mean |kernel - "
          f"plain in float32| {mean_diff} over {limit} ({FLASH_MEAN_LIMIT} x mean |plain|)")
    if all_rows_control:
        check(control > limit, f"flash_attention: the control without key tile {tile} reads "
              f"{control}, not above the limit {limit}: the check cannot see a dropped tile")
    check(mean_diff_r <= limit_r, f"flash_attention bf16 at the serving inputs, rows that key "
          f"tile {tile} reaches: mean |kernel - plain in float32| {mean_diff_r} over {limit_r}")
    check(control_r > limit_r, f"flash_attention: the control without key tile {tile} reads "
          f"{control_r} over the rows it reaches, not above the limit {limit_r}: the check "
          f"cannot see a dropped tile")
    log(f"flash_attention bf16 at the serving inputs: mean |kernel - plain in float32| "
        f"{mean_diff:.6g}, limit {limit:.6g} ({FLASH_MEAN_LIMIT} x mean |plain| "
        f"{mean_plain:.6g}); the plain version without key tile {tile}: {control:.6g}"
        f"{'' if all_rows_control else ' (not held to the limit here)'}; over the "
        f"{int(reach.sum())} rows that tile reaches {mean_diff_r:.6g}, limit {limit_r:.6g}, "
        f"without the tile {control_r:.6g}; "
        f"SDPA: {sdpa_mean if sdpa_mean is None else f'{sdpa_mean:.6g}'}")
    p1, k1, k2, p2 = (cuda_ms(f, reps=10) for f in (
        lambda: flash_attention_ref(q, k, v, **kw), lambda: flash_attention_cuda(q, k, v, **kw),
        lambda: flash_attention_cuda(q, k, v, **kw), lambda: flash_attention_ref(q, k, v, **kw)))
    lib_ms = cuda_ms(library, reps=10) if sdpa_ok else None
    bound = flash_bound(B, Hq, k.shape[1], Sq, Sk, D, q.element_size(), causal, window,
                        q_offset)
    return {
        "shape": [B, Hq, k.shape[1], Sq, Sk, D], "dtype": str(q.dtype), "kwargs": kw,
        **bound, "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
        "max_abs_err": err, "max_abs_err_f32": err32, "library_max_abs_err": lib_err,
        "mean_abs_err_vs_f32": mean_diff, "mean_limit": limit, "control_dropped_tile": control,
        "mean_abs_err_vs_f32_reach": mean_diff_r, "mean_limit_reach": limit_r,
        "control_dropped_tile_reach": control_r, "library_mean_abs_err_vs_f32": sdpa_mean,
        "tflops": bound["ops"] / (min(k1, k2) * 1e-3) / 1e12,
    }


def ssd_ops_needed(BH: int, BG: int, L: int, P: int, N: int, Q: int) -> int:
    """Operations of the chunked form at chunk Q on this data: per chunk of
    r rows, the lower triangle of C B^T (r(r+1)/2 N multiply-adds) once per
    group, since it does not depend on the head; per head, that triangle's
    product with xdt (r(r+1)/2 P), C S for every chunk after the first
    (r N P) and the state update for every chunk but the last (r N P).
    It grows with Q; at Q = 1 it is the recurrence's own work."""
    per_group = per_head = 0
    for c, c0 in enumerate(range(0, L, Q)):
        r = min(Q, L - c0)
        tri = r * (r + 1) // 2
        per_group += tri * N
        per_head += tri * P
        if c > 0:
            per_head += r * N * P
        if c0 + Q < L:
            per_head += r * N * P
    return 2 * (per_group * BG + per_head * BH)


#: the chunk at which ssd_scan's bound is counted: 1, the per-step
#: recurrence (S_t = exp(dtA_t) S_{t-1} + B_t xdt_t^T, y_t = C_t S_t, ~4 N P
#: operations a row and head).  At the serving path's lengths every longer
#: chunk computes the same function with more operations (its lower
#: triangle grows with the chunk), so this is the least work the function
#: needs, whatever chunk a kernel takes; counted at the kernel's own chunk,
#: a kernel with a smaller chunk would read a smaller bound.  For short
#: sequences (L = 100 at mamba2-370m's widths) one quadratic chunk needs
#: fewer, and :func:`ssd_bound` refuses such a shape.
SSD_BOUND_CHUNK = 1


def ssd_bound(BH: int, BG: int, L: int, P: int, N: int) -> tuple[int, int]:
    """(operations, bytes) that ssd_scan needs at these shapes: operations
    at :data:`SSD_BOUND_CHUNK`, after checking that no chunk length in
    1..L needs fewer; bytes for xdt, dtA and y once per head, B and C once
    per group, float32."""
    ops_count = ssd_ops_needed(BH, BG, L, P, N, SSD_BOUND_CHUNK)
    least = min(range(1, L + 1), key=lambda q: ssd_ops_needed(BH, BG, L, P, N, q))
    check(least == SSD_BOUND_CHUNK, f"ssd_scan bound: at L = {L} chunk {least} needs fewer "
          f"operations than chunk {SSD_BOUND_CHUNK}; the bound would not be a least time")
    nbytes = 4 * (2 * BH * L * P + BH * L + 2 * BG * L * N)
    return ops_count, nbytes


def ssd_bwd_ops_needed(BH: int, L: int, P: int, N: int) -> int:
    """Operations of ssd_scan's backward at chunk 1, the reverse
    recurrence: per row and head, G_t = C_t dy_t^T + exp(dtA_{t+1}) G_{t+1},
    dxdt_t = G_t^T B_t, dB_t = G_t xdt_t, dC_t = S_t dy_t and the forward
    state S_t recomputed alongside, each N P multiply-adds: 10 N P
    operations, 2.5x the forward's 4 N P (dB and dC summed over a group's
    heads inside those multiply-adds).  ddtA_t = exp(dtA_t) <G_t, S_{t-1}>
    needs no N P term of its own: <G_t, S_t> is both ddtA_t + xdt_t . dxdt_t
    and dy_t . y_t + ddtA_{t+1}, so ddtA is the reverse cumsum of
    dy_t . y_t - xdt_t . dxdt_t, O(P) a row with y the forward's output."""
    return 10 * N * P * L * BH


def ssd_bwd_bound(BH: int, BG: int, L: int, P: int, N: int) -> tuple[int, int]:
    """(operations, bytes) that ssd_scan's backward needs at these shapes:
    operations at chunk 1 (:func:`ssd_bwd_ops_needed`); bytes for xdt, dtA,
    dy, dxdt and ddtA once per head, B, C, dB and dC once per group,
    float32 (the forward's scratch is the kernels' choice, not counted)."""
    return (ssd_bwd_ops_needed(BH, L, P, N),
            4 * (3 * BH * L * P + 2 * BH * L + 4 * BG * L * N))


#: TF32 on the tensor cores taken three times (3xTF32), TFLOP/s: 495 / 3
TF32X3_OPS_PER_S = 495e12 / 3


def ssd_bwd_kernel_bounds(BH: int, BG: int, L: int, P: int, N: int) -> dict[str, dict]:
    """Each backward kernel's own bound at these shapes, by kernel name:
    its share of the reverse recurrence's 10 N P operations a row and head
    (:func:`ssd_bwd_ops_needed`), dS_in 2 N P (``ssd_bwd_dstate``), dxdt 2
    N P (``ssd_bwd_chunk_dx``), dB and dC 4 N P (``ssd_bwd_chunk_dbc``), the
    rest none of its own (2 N P, the forward state recomputed alongside,
    the kernels read instead); and the bytes that kernel alone must move,
    counted as :func:`ssd_bwd_bound` counts them: each input it reads and
    each gradient it writes once, float32, the forward's scratch not
    counted.  The state pass reads and writes none of those: its bytes are
    g_c's at the kernels' chunk of 64, read and written once.  ``bound_ms`` takes the operations at the
    float32 rate (67 TFLOP/s); for the kernels whose products run as 3xTF32
    (:data:`SSD_BWD_TC`) ``tf32x3_ms`` gives them at 495 / 3 TFLOP/s."""
    row, head_rows, group_rows = BH * L, BH * L * P, BG * L * N
    n_states = max(-(-L // 64) - 1, 0)
    counts = {
        "ssd_bwd_dstate": (2, head_rows + row + group_rows),  # dy, dtA, C
        "ssd_bwd_state_pass": (0, 2 * BH * n_states * N * P),  # g_c
        "ssd_bwd_chunk_dx": (2, 3 * head_rows + row + group_rows),  # dy, xdt, dtA, B; dxdt
        "ssd_bwd_chunk_dbc": (4, 2 * head_rows + row + 2 * group_rows),  # xdt, dy, dtA, B, C
        "ssd_bwd_dbc_sum": (0, 2 * group_rows),  # dB, dC
        "ssd_bwd_ddtA": (0, row),  # ddtA
    }
    out = {}
    for name, (share, floats) in counts.items():
        ops_count, nbytes = share * N * P * L * BH, 4 * floats
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops_count / F32_OPS_PER_S * 1e3
        tc_ms = (max(bytes_ms, ops_count / TF32X3_OPS_PER_S * 1e3) if name in SSD_BWD_TC
                 else None)
        out[name] = {"ops": ops_count, "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "tf32x3_ms": tc_ms}
    return out


def pass_split_ms(call, reps: int = 10) -> dict[str, float]:
    """Mean device time of each of a call's launches, from CUDA events
    between them over ``reps`` runs of the whole sequence."""
    import torch

    for _, launch in call.passes:  # warm
        launch()
    marks = []
    for _ in range(reps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(call.passes) + 1)]
        events[0].record()
        for (_, launch), event in zip(call.passes, events[1:]):
            launch()
            event.record()
        marks.append(events)
    torch.cuda.synchronize()
    return {name: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / reps
            for i, (name, _) in enumerate(call.passes)}


def host_ms_per_call(fn, calls: int = 50) -> float:
    """Mean host-clock time (ms) to issue one call of ``fn``, which launches
    without synchronising: the calls run back to back with no sync between
    them, so the card's queue absorbs their device time and the clock reads
    the host's own cost (checks, allocation, launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return host


def time_ssd(args) -> dict:
    """ssd_scan on the serving path's own inputs: checked against the plain
    chunked version, timed beside it and beside the bound of this data
    (:func:`ssd_bound`: operations at the float32 peak, bytes at the
    memory rate), split by pass, with the scratch the passes hand on.  No
    PyTorch call computes the SSD scan."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked
    from repro_torch.kernels.ssd_scan.ssd_scan import plan, ssd_scan_cuda

    (xdt, dtA, B, C, n_rep), _ = args
    BH, L, P = xdt.shape
    N = B.shape[2]
    out = ssd_scan_cuda(xdt, dtA, B, C, n_rep)
    ref = ssd_scan_chunked(xdt, dtA, B, C, n_rep)
    err = rel_err(out, ref)
    check(err < 3e-4, f"ssd_scan at the serving inputs: error {err} of max|y|")
    max_abs = float((out - ref).abs().max())
    del ref
    p1, k1, k2, p2 = (cuda_ms(f, reps=10) for f in (
        lambda: ssd_scan_chunked(xdt, dtA, B, C, n_rep), lambda: ssd_scan_cuda(xdt, dtA, B, C, n_rep),
        lambda: ssd_scan_cuda(xdt, dtA, B, C, n_rep), lambda: ssd_scan_chunked(xdt, dtA, B, C, n_rep)))
    call = plan(xdt, dtA, B, C, n_rep)
    split = pass_split_ms(call)
    scratch = call.scratch_bytes()
    del call
    host = host_ms_per_call(lambda: ssd_scan_cuda(xdt, dtA, B, C, n_rep))
    ops_count, nbytes = ssd_bound(BH, B.shape[0], L, P, N)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_count / F32_OPS_PER_S * 1e3
    log(f"ssd_scan at the serving inputs {[BH, B.shape[0], L, P, N]}: scratch "
        f"{scratch / 1e6:.3f} MB; device ms by pass "
        f"{ {name: round(ms, 4) for name, ms in split.items()} } (sum {sum(split.values()):.4f}); "
        f"host ms to issue one call {host:.4f}")
    return {
        "shape": [BH, B.shape[0], L, P, N], "ops": ops_count, "bytes": nbytes,
        "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": None,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "max_abs_err": max_abs, "max_rel_err": err,
        "tflops": ops_count / (min(k1, k2) * 1e-3) / 1e12,
        "scratch_bytes": scratch, "pass_ms": split, "host_ms": host,
    }


#: the MoE smoke configs' float32 cross-device gate, x max|logit|: float32
#: on both sides (no TF32), the card's float32 flash and ssd kernels within
#: 2e-5 and 3e-4 of their plain versions, sums in another order
MOE_F32_TOL = 1e-3


def lm_cross_device_phase() -> dict:
    """The smoke configs with the same parameters on the CPU and on the
    card: prefill logits, then 4 teacher-forced decode steps, within
    2e-2 x max|logit| (bf16 activations summed in another order); and the
    admission verdicts at the rules' edges, equal.  phi3's and gemma3's
    smoke configs take their published head dims (96, 256), so the card
    runs those flash instances; gemma3's 16-token window is shorter than
    the 24-token prompt, and its embeddings are tied.  minicpm3's
    (:data:`PUBLISHED_MLA`) runs twice: at its smoke MLA dims, then at the
    published ones.  Beside each run at a published dim, the same run on
    the card with the plain version in place of the kernel (P in float32,
    never rounded to bf16) is read against the CPU: where the kernel's
    reading nears the tolerance, that tells its P rounding from the rest
    of the card's arithmetic.

    The MoE archs (:data:`MOE_SMOKE_ARCHS`; jamba's hybrid stack runs
    flash_attention and ssd_scan in one model) are gated with float32
    activations and caches on both sides, within :data:`MOE_F32_TOL`: in
    bf16 a token whose k-th and (k + 1)-th router weights lie within
    rounding of each other can take another expert on the card than on the
    CPU, a step in its logits.  Their bf16 run is read, not gated: its gap
    beside the number of (token, layer) routes that differ.

    The cross-attention archs' smoke configs (:data:`CROSS_SERVE`, every
    gate at :data:`CROSS_GATE`; llama-3.2-vision's also at its published
    head dim 128, so the card runs ``<128>`` on a model) over a unit-normal
    memory, in bf16 at the same 2e-2 x max|logit|, their flash launches
    counted (the prefill's calls, then one a cross layer a decode step);
    a control: the card over a memory drawn from another seed must read
    outside the limit.  Returns the MoE archs' readings and the cross
    archs' (``{"moe": ..., "cross": ...}``)."""
    import dataclasses

    import torch

    from repro_torch.configs import config_for, smoke_config_for
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import _router_probs
    from repro_torch.serve.admission import AdmissionPolicy

    def to_card(t):
        if isinstance(t, dict):
            return {k: to_card(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_card(v) for v in t]
        return t.to("cuda")

    def teacher_forced(model, device, toks, steps, routes=None, memory=None):
        """The prefill's logits (over ``memory`` where given) and each
        decode step's, on the CPU; with ``routes``, each MoE call's chosen
        experts (a sorted row a token) appended to it in call order."""
        moe = T.moe

        def recorded(params, x, top_k):
            probs = _router_probs(params, x.reshape(-1, x.shape[-1]))
            chosen = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :top_k]
            routes.append(torch.sort(chosen, dim=-1)[0].cpu())
            return moe(params, x, top_k)

        if routes is not None:
            T.moe = recorded
        try:
            logits, cache = model.prefill(
                toks.to(device), None if memory is None else memory.to(device), max_len=64)
            out = [logits.cpu()]
            for nt in steps:
                logits, cache = model.decode_step(cache, nt.to(device))
                out.append(logits.cpu())
        finally:
            T.moe = moe
        return out

    def worst(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def with_plain_flash(run):
        """``run()`` with the plain version in the kernel's place on the card."""
        # by path: the package's own ``flash_attention`` is the ops function
        fa_binding = importlib.import_module(
            "repro_torch.kernels.flash_attention.flash_attention")
        kernel = fa_binding.flash_attention_cuda
        fa_binding.flash_attention_cuda = lambda q, k, v, **kw: flash_attention_ref(
            q, k, v, **kw)
        try:
            return run()
        finally:
            fa_binding.flash_attention_cuda = kernel

    def float32_compute():
        """Patch the stack to float32 activations and caches; returns the
        undo."""
        saved = T.COMPUTE_DTYPE, T.init_cache.__defaults__
        T.COMPUTE_DTYPE = torch.float32
        T.init_cache.__defaults__ = (0, torch.float32, None)

        def undo():
            T.COMPUTE_DTYPE, T.init_cache.__defaults__ = saved
        return undo

    moe_out = {}
    runs = []  # (arch, smoke config, whether it takes a published dim)
    for arch in dict.fromkeys([a for a, _, _ in SERVE_ARCHS] + list(MOE_SMOKE_ARCHS)):
        cfg = smoke_config_for(arch)
        if arch in PUBLISHED_HEAD_DIM:
            cfg = dataclasses.replace(cfg, head_dim=config_for(arch).head_dim)
        runs.append((arch, cfg, arch in PUBLISHED_HEAD_DIM))
        if arch in PUBLISHED_MLA:
            full = config_for(arch)
            runs.append((arch, dataclasses.replace(cfg, mla=full.mla, head_dim=full.head_dim),
                         True))
    # the cross models' smoke configs over a memory (A18), llama-3.2-vision's
    # again at its published head dim 128
    cross_runs = [(arch, smoke_config_for(arch)) for arch, _ in CROSS_SERVE]
    cross_runs.append(("llama32_vision_90b", dataclasses.replace(
        smoke_config_for("llama32_vision_90b"),
        head_dim=config_for("llama32_vision_90b").head_dim)))
    cross_out = {}
    for arch, cfg, published in runs:
        tree = T.init_params(torch.Generator("cpu").manual_seed(0), cfg, "cpu")
        models = {"cpu": build_model(cfg, "cpu").load(tree),
                  "card": build_model(cfg).load(to_card(tree))}
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
        steps = [torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32))
                 for _ in range(4)]
        if arch in MOE_SMOKE_ARCHS:
            undo = float32_compute()
            try:
                cpu = teacher_forced(models["cpu"], "cpu", toks, steps)
                fa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0  # the card's float32 run only
                card = teacher_forced(models["card"], "cuda", toks, steps)
                launches = {"flash_attention": fa_ops.LAUNCHES, "ssd_scan": ssd_ops.LAUNCHES}
            finally:
                undo()
            tol = MOE_F32_TOL * float(cpu[0].abs().max())
            check(all(bool(torch.isfinite(x).all()) for x in card),
                  f"{cfg.name} smoke float32: non-finite logits on the card")
            for step, (x, y) in enumerate(zip(cpu, card)):
                err = float((x - y).abs().max())
                what = "prefill" if step == 0 else f"decode {step - 1}"
                check(err <= tol, f"{cfg.name} smoke float32 {what}: cpu vs card {err} > {tol}")
            mixers = {spec.mixer for spec in cfg.super_block}
            want = {"flash_attention": "attn" in mixers, "ssd_scan": "mamba" in mixers}
            check(all((n > 0) == want[k] for k, n in launches.items()),
                  f"{cfg.name} smoke float32 on the card: kernel launches {launches}, expected "
                  f"some of {[k for k, w in want.items() if w]} and none of the others")
            routes_cpu, routes_card = [], []
            cpu16 = teacher_forced(models["cpu"], "cpu", toks, steps, routes_cpu)
            card16 = teacher_forced(models["card"], "cuda", toks, steps, routes_card)
            differ = sum(int((a != b).any(dim=-1).sum()) for a, b in zip(routes_cpu, routes_card))
            total = sum(a.shape[0] for a in routes_cpu)
            moe_out[arch] = {"f32_max_abs_diff": worst(cpu, card), "f32_tol": tol,
                             "f32_launches": launches, "bf16_max_abs_diff": worst(cpu16, card16),
                             "bf16_max_abs_logit": float(cpu16[0].abs().max()),
                             "bf16_routes_differ": differ, "routes": total}
            log(f"LM cross-device: {cfg.name} smoke (MoE, {cfg.moe.n_experts} experts, top "
                f"{cfg.moe.top_k}) prefill + 4 decode steps in float32, cpu vs card max |diff| "
                f"{worst(cpu, card):.3g} (tolerance {tol:.3g}); card launches {launches}; in "
                f"bf16, not gated: max |diff| {moe_out[arch]['bf16_max_abs_diff']:.3g} of "
                f"max|logit| {moe_out[arch]['bf16_max_abs_logit']:.3g}, {differ} of {total} "
                f"(token, layer) routes differ")
            continue
        cpu = teacher_forced(models["cpu"], "cpu", toks, steps)
        fa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0  # the card's run only
        card = teacher_forced(models["card"], "cuda", toks, steps)
        mixers = {spec.mixer for spec in cfg.super_block}
        launches = {"flash_attention": fa_ops.LAUNCHES, "ssd_scan": ssd_ops.LAUNCHES}
        want = {"flash_attention": "attn" in mixers, "ssd_scan": "mamba" in mixers}
        check(all((n > 0) == want[k] for k, n in launches.items()),
              f"{cfg.name} smoke on the card: kernel launches {launches}, expected some of "
              f"{[k for k, w in want.items() if w]} and none of the others")
        tol = 2e-2 * float(cpu[0].abs().max())
        for step, (x, y) in enumerate(zip(cpu, card)):
            err = float((x - y).abs().max())
            what = "prefill" if step == 0 else f"decode {step - 1}"
            check(err <= tol, f"{cfg.name} smoke {what}: cpu vs card {err} > {tol}")
        plain = ""
        if published:
            card_plain = with_plain_flash(
                lambda: teacher_forced(models["card"], "cuda", toks, steps))
            plain = (f"; with the plain version (P in float32) in place of the kernel on the "
                     f"card {worst(cpu, card_plain):.3g}")
        dims = (f"MLA qk {cfg.mla.qk_nope_head_dim} + {cfg.mla.qk_rope_head_dim}, v "
                f"{cfg.mla.v_head_dim}" if cfg.mla else f"head dim {cfg.head_dim}")
        log(f"LM cross-device: {cfg.name} smoke ({dims}) prefill + 4 decode "
            f"steps, cpu vs card max |diff| {worst(cpu, card):.3g} (tolerance {tol:.3g})"
            + plain)
    for arch, cfg in cross_runs:
        tree = T.init_params(torch.Generator("cpu").manual_seed(0), cfg, "cpu")
        set_gates(tree)
        models = {"cpu": build_model(cfg, "cpu").load(tree),
                  "card": build_model(cfg).load(to_card(tree))}
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
        steps = [torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32))
                 for _ in range(4)]
        M = cfg.vision_tokens or 24  # audio frames as long as the prompt
        memory, redrawn = (torch.as_tensor(np.random.default_rng(seed).standard_normal(
            (2, M, cfg.d_model), dtype=np.float32)).to(torch.bfloat16) for seed in (2, 3))
        cpu = teacher_forced(models["cpu"], "cpu", toks, steps, memory=memory)
        fa_ops.LAUNCHES = 0  # the card's run only
        card = teacher_forced(models["card"], "cuda", toks, steps, memory=memory)
        launches = fa_ops.LAUNCHES
        per = cross_layer_counts(cfg)
        want = sum(per.values()) + 4 * per["cross"]
        check(launches == want, f"{cfg.name} smoke on the card: flash launches {launches}, "
              f"expected {want} (prefill {per}, then the cross layers a decode step)")
        tol = 2e-2 * float(cpu[0].abs().max())
        for step, (x, y) in enumerate(zip(cpu, card)):
            err = float((x - y).abs().max())
            what = "prefill" if step == 0 else f"decode {step - 1}"
            check(err <= tol, f"{cfg.name} smoke {what}: cpu vs card {err} > {tol}")
        # control: the card over a memory drawn from another seed must read
        # outside the limit against the CPU
        other = teacher_forced(models["card"], "cuda", toks, steps, memory=redrawn)
        control = worst(cpu, other)
        check(control > tol, f"{cfg.name} smoke: with the memory redrawn the card reads "
              f"{control}, within the limit {tol}: the check cannot see the memory")
        card_plain = with_plain_flash(
            lambda: teacher_forced(models["card"], "cuda", toks, steps, memory=memory))
        log(f"LM cross-device: {cfg.name} smoke (head dim {cfg.head_dim}, memory of {M}, "
            f"gates at {CROSS_GATE}) prefill + 4 decode steps, cpu vs card max |diff| "
            f"{worst(cpu, card):.3g} (tolerance {tol:.3g}); with the plain version (P in "
            f"float32) in place of the kernel on the card {worst(cpu, card_plain):.3g}; card "
            f"flash launches {launches}; with the memory redrawn {control:.3g}")
        cross_out[cfg.name + ("" if cfg.head_dim == smoke_config_for(arch).head_dim
                              else f"/head_dim{cfg.head_dim}")] = {
            "max_abs_diff": worst(cpu, card), "tol": tol, "launches": launches,
            "plain_on_card_max_abs_diff": worst(cpu, card_plain),
            "redrawn_memory_diff": control}
    plen = [2048, 2049, 8192, 8193, 32768, 32769, 100, 5000]
    reqs = {"tier": np.array([0, 1, 2, 0, 1, 2, 0, 1]), "prompt_len": np.array(plen),
            "max_new_tokens": np.array([32, 5000, 300, 2000, 10, 10, 256, 1024]),
            "temperature": np.array([-0.1, 2.1, 0.0, 0.7, 1.0, 1.5, 2.0, 0.5])}
    a = AdmissionPolicy(device="cpu").evaluate(reqs)
    b = AdmissionPolicy().evaluate(reqs)
    for name in a:
        check(np.array_equal(a[name], b[name]), f"admission {name}: cpu {a[name]} vs card {b[name]}")
    log("LM cross-device: admission verdicts cpu == card")
    return {"moe": moe_out, "cross": cross_out}


# ---------------------------------------------------------------------------
# training (ROADMAP A16.1)
# ---------------------------------------------------------------------------

#: (label, B, Hq, Hk, Sq, Sk, D, kwargs): the backward kernels against
#: ``flash_attention_bwd_ref`` in float32 and bf16.  granite-3-2b's training
#: layer (a microbatch of 2 x 4,096 tokens); gemma3-12b's 1,024-key window at
#: D = 256 with MHA and a query offset, at 1, 40 and 1,000 queries, and at
#: D = 64 with GQA; rows with no valid key, all of them and some of them; a
#: decode row at D = 128.  bf16 runs on the tensor cores, float32 on the
#: CUDA cores.
FLASH_BWD_CASES = [
    ("d16", 1, 4, 2, 300, 300, 16, dict(causal=True)),
    ("granite3_2b", 2, 32, 8, 4096, 4096, 64, dict(causal=True)),
    ("d96_full", 1, 4, 4, 500, 700, 96, dict(causal=False)),
    ("d128", 1, 4, 2, 600, 600, 128, dict(causal=True, window=200)),
    ("gemma3_local_S1", 1, 4, 4, 1, 1500, 256, dict(causal=True, window=1024, q_offset=1499)),
    ("gemma3_local_S40", 1, 4, 4, 40, 1500, 256, dict(causal=True, window=1024, q_offset=1460)),
    ("gemma3_local_S1000", 1, 4, 4, 1000, 1500, 256,
     dict(causal=True, window=1024, q_offset=500)),
    ("fully_masked", 1, 2, 1, 8, 16, 64, dict(causal=False, window=4, q_offset=40)),
    ("some_rows_masked", 1, 2, 1, 8, 16, 64, dict(causal=False, window=4, q_offset=14)),
    ("d64_window_S40", 1, 8, 2, 40, 1500, 64, dict(causal=True, window=1024, q_offset=1460)),
    ("d128_S1", 2, 4, 4, 1, 700, 128, dict(causal=True, q_offset=699)),
]
#: max |kernel - plain| over max |plain|, per gradient: float32 sums in
#: another order; in bf16 both round float32 sums to bf16 at the end (one
#: bf16 ulp is 2^-8 of the value)
FLASH_BWD_TOL = {"float32": 2e-5, "bfloat16": 8e-3}
#: the forward's log-sum-exp against the plain one's, absolute
FLASH_LSE_TOL = 1e-4
#: the autograd.Function against torch autograd of the float32 plain
#: version, max |diff| over max |grad|
FLASH_AUTOGRAD_TOL = 1e-4
#: granite-3-2b's training run: 6 steps of 4 x 4,096 tokens in 2 microbatches
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 4096, 2
#: the pipeline step whose batch the run does not train on and whose loss
#: must fall over the run: the same tokens before and after, so the check
#: does not compare one batch's loss with another's (on uniform tokens the
#: batches' losses differ by more than 6 steps lower them)
TRAIN_HELD_OUT_STEP = 50
#: the initial states ``--train-seeds`` trains from
TRAIN_SEEDS = (0, 1, 2)
#: the first step on one 1,024-token sequence, kernels against the plain
#: attention swapped in: relative limits on the loss and the gradient norm
#: (the forward kernel rounds P to bf16 before P V, which the plain version
#: does not; the backward kernels and autograd sum in another order)
KERNEL_VS_PLAIN_TOL = {"loss": 1e-3, "grad_norm": 1e-2}
#: the smoke config on the card against the CPU over 8 steps, relative per
#: step loss (bf16 activations summed in another order, P rounded to bf16
#: in the card's forward kernel)
SMOKE_LOSS_TOL = 5e-3
#: the same runs held to what the 8 steps did: ``loss`` limits the largest
#: per-step |card - CPU| loss gap over the largest move the CPU's steps made
#: in a batch's loss (its loss at that step less the initial tree's loss of
#: the same batch); ``move`` limits, per parameter leaf, |card's move - the
#: CPU's move| over |the CPU's move| (a move: final - initial, Frobenius
#: norms).  Set from ``--train-seeds``' runs (PERF.md, PR 31): a healthy
#: card reads about a third of them, a control run in which one kernel's
#: gradient is zeroed reads ~1 on ``move``, which it must fail
SMOKE_MOVE_TOL = {"loss": 0.2, "move": 0.2}


def flash_backward_checks() -> dict:
    """(a): the backward kernels against ``flash_attention_bwd_ref`` at
    :data:`FLASH_BWD_CASES` in both dtypes, the forward's lse against the
    plain one's, dQ/dK/dV bit-equal across two launches, and the
    ``autograd.Function`` (through ``ops.flash_attention``, inside a
    non-reentrant checkpoint; D = 64 and D = 24 through the zero padding)
    against torch autograd of the float32 plain version."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_ref)

    g = torch.Generator(device="cuda").manual_seed(29)
    errs, max_abs = {}, 0.0
    for label, B, Hq, Hk, Sq, Sk, D, kw in FLASH_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q, do = (torch.randn((B, Hq, Sq, D), generator=g, device="cuda").to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((B, Hk, Sk, D), generator=g, device="cuda").to(dtype)
                    for _ in range(2))
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            _, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
            finite = torch.isfinite(lse_ref)
            check(torch.equal(torch.isfinite(lse), finite),
                  f"flash lse at {label} {name}: rows with no valid key differ")
            lse_err = float((lse[finite] - lse_ref[finite]).abs().max()) if finite.any() else 0.0
            check(lse_err <= FLASH_LSE_TOL, f"flash lse at {label} {name}: {lse_err}")
            got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            rel = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
            for n, a, b in zip(("dq", "dk", "dv"), got, want):
                check(a.dtype == dtype and a.shape == b.shape, f"flash bwd {label}: {n} shape")
                check(rel[n] <= FLASH_BWD_TOL[name],
                      f"flash backward at {label} {name}: {n} max |kernel - plain| / max "
                      f"|plain| {rel[n]} over {FLASH_BWD_TOL[name]}")
                max_abs = max(max_abs, float((a.float() - b.float()).abs().max()))
            if label.endswith("masked") and label.startswith("fully"):
                check(not any(t.any() for t in got), f"flash backward {label}: nonzero gradient")
            errs[f"{label}/{name}"] = {**rel, "lse": lse_err}
            if label == "granite3_2b" and dtype == torch.bfloat16:
                again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      "flash backward at granite3_2b bf16: two launches differ (dQ, dK or dV)")
            del q, k, v, o, do, got, want
    torch.cuda.empty_cache()
    autograd = {}
    for D in (64, 24):
        q = torch.randn((2, 4, 300, D), generator=g, device="cuda").requires_grad_()
        k, v = (torch.randn((2, 2, 300, D), generator=g, device="cuda").requires_grad_()
                for _ in range(2))
        w = torch.randn((2, 4, 300, D), generator=g, device="cuda")

        def loss(attend, q, k, v):
            return (attend(q, k, v, causal=True, window=200) * w).sum()

        fwd, bwd = fa_ops.LAUNCHES, fa_ops.BACKWARD_LAUNCHES
        checkpoint(loss, fa_ops.flash_attention, q, k, v, use_reentrant=False).backward()
        check(fa_ops.LAUNCHES == fwd + 2 and fa_ops.BACKWARD_LAUNCHES == bwd + 1,
              f"flash autograd at D = {D}: launches {fa_ops.LAUNCHES - fwd} forward, "
              f"{fa_ops.BACKWARD_LAUNCHES - bwd} backward under checkpoint, not 2 and 1")
        got = [t.grad for t in (q, k, v)]
        want = torch.autograd.grad(loss(flash_attention_ref, q, k, v), (q, k, v))
        autograd[D] = max(rel_err(a, b) for a, b in zip(got, want))
        check(autograd[D] <= FLASH_AUTOGRAD_TOL,
              f"flash autograd.Function at D = {D}: {autograd[D]} over {FLASH_AUTOGRAD_TOL}")
    worst = {name: max(max(e[n] for n in ("dq", "dk", "dv")) for key, e in errs.items()
                       if key.endswith(name)) for name in FLASH_BWD_TOL}
    log(f"train (a): flash backward == flash_attention_bwd_ref at {len(errs)} cases "
        f"(worst max |diff| / max |plain|: float32 {worst['float32']:.3g}, limit "
        f"{FLASH_BWD_TOL['float32']}; bf16 {worst['bfloat16']:.3g}, limit "
        f"{FLASH_BWD_TOL['bfloat16']}); lse within {max(e['lse'] for e in errs.values()):.3g} "
        f"(limit {FLASH_LSE_TOL}); dQ/dK/dV bit-equal across two launches; autograd.Function "
        f"under checkpoint vs torch autograd of the float32 plain version: D = 64 "
        f"{autograd[64]:.3g}, D = 24 (padded) {autograd[24]:.3g} (limit {FLASH_AUTOGRAD_TOL})")
    return {"cases": errs, "max_abs_err": max_abs, "autograd": autograd}


def train_pipeline_check(vocab: int) -> dict:
    """(b): the data pipeline at seed 0, steps 0-3, batch 8 x 4,096: FROID
    == INTERPRETED on the card == the CPU's batch, bit for bit, and the
    tokens equal ``synthetic_corpus``'s."""
    import torch

    from repro_torch.data.pipeline import DataPipeline, synthetic_corpus

    t0 = time.perf_counter()
    pipes = {"froid": DataPipeline(batch=8, seq_len=4096, vocab=vocab),
             "interpreted": DataPipeline(batch=8, seq_len=4096, vocab=vocab, froid=False),
             "cpu": DataPipeline(batch=8, seq_len=4096, vocab=vocab, device="cpu")}
    for step in range(4):
        out = {name: p.batch_at(step) for name, p in pipes.items()}
        check(out["froid"]["tokens"].is_cuda, "the pipeline's batch is not on the card")
        for key in out["cpu"]:
            for name in ("froid", "interpreted"):
                check(torch.equal(out[name][key].cpu(), out["cpu"][key]),
                      f"pipeline step {step}: {name} {key} differs from the CPU's")
        toks = synthetic_corpus(0, step, 8, 4096, vocab)
        check(np.array_equal(out["froid"]["tokens"].cpu().numpy(), toks[:, :-1]),
              f"pipeline step {step}: tokens differ from synthetic_corpus")
    seconds = time.perf_counter() - t0
    log(f"train (b): pipeline steps 0-3 at 8 x 4,096, FROID == INTERPRETED on the card == "
        f"the CPU bit for bit, tokens == synthetic_corpus ({seconds:.1f} s)")
    return {"seconds": seconds}


def _capture_flash_backward(store: dict):
    """Wrap the backward binding so that its first call's inputs are kept
    (clones): the training path's own inputs for (e).  Returns the
    original, to put back."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_binding

    original = fa_binding.flash_attention_bwd_cuda

    def capture(q, k, v, o, lse, do, **kw):
        if not store:
            store["args"] = tuple(t.clone() for t in (q, k, v, o, lse, do))
            store["kw"] = dict(kw)
        return original(q, k, v, o, lse, do, **kw)

    fa_binding.flash_attention_bwd_cuda = capture
    return original


def held_out_loss(model, params, batch) -> float:
    """The loss of ``batch`` under ``params`` (bf16 compute, as a training
    step), without gradients."""
    import torch

    from repro_torch.train.train_loop import compute_params

    with torch.no_grad():
        return float(model.loss_fn(compute_params(params), batch, remat=False))


def six_steps(model, cfg, seed: int, history: list) -> dict:
    """(c)'s and (g)'s run: ``train_loop`` over :data:`TRAIN_STEPS` steps
    from seed ``seed``'s initial state, and the held-out batch's loss
    before and after.  Returns the state, the pipeline, both losses, the
    steps' peak GB and the flash and ssd_scan launches (forward, backward)
    of the steps alone (the counts set to 0 just before them)."""
    import torch

    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_loop import init_state, train_loop

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    state = init_state(model, torch.Generator("cuda").manual_seed(seed), opt_cfg)
    pipe = DataPipeline(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab)
    held_out = pipe.batch_at(TRAIN_HELD_OUT_STEP)
    before = held_out_loss(model, state.params, held_out)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES = fa_ops.BACKWARD_LAUNCHES = 0
    ssd_ops.LAUNCHES = ssd_ops.BACKWARD_LAUNCHES = 0
    state = train_loop(model, state, iter(pipe), opt_cfg, steps=TRAIN_STEPS,
                       microbatches=TRAIN_MICRO, log_every=0, history=history)
    launches = {"flash_attention": (fa_ops.LAUNCHES, fa_ops.BACKWARD_LAUNCHES),
                "ssd_scan": (ssd_ops.LAUNCHES, ssd_ops.BACKWARD_LAUNCHES)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = held_out_loss(model, state.params, held_out)
    return {"state": state, "pipe": pipe, "held_out_before": before, "held_out_after": after,
            "peak_gb": peak_gb, "launches": launches}


def trained_figures(label: str, kernel: str, model, cfg, opt_cfg, run: dict,
                    history: list, held_out_gate: bool = True) -> dict:
    """The checks and figures (c) and (g) share on a :func:`six_steps`
    run: losses finite, the held-out batch's loss falling (where
    ``held_out_gate``; else only read), ``kernel``'s forward launches twice
    (remat) and its backward once a layer a microbatch, ms a step over
    steps 3-6, tokens/s, peak GB, and one traced step (the batch of step
    7)."""
    from repro_torch.train.train_loop import make_train_step

    held_before, held_after = run["held_out_before"], run["held_out_after"]
    fwd, bwd = run["launches"][kernel]
    losses = [h["loss"] for h in history]
    per_step = cfg.n_repeats * len(cfg.super_block) * TRAIN_MICRO
    check(all(math.isfinite(x) for x in losses + [held_before, held_after]),
          f"{label} training: a loss is not finite: {losses}, held-out {held_before} / "
          f"{held_after}")
    check(held_after < held_before or not held_out_gate, f"{label} training: the loss of the "
          f"batch of pipeline step {TRAIN_HELD_OUT_STEP}, not trained on, went from "
          f"{held_before} before the {TRAIN_STEPS} steps to {held_after} after: not falling")
    check(fwd == 2 * per_step * TRAIN_STEPS and bwd == per_step * TRAIN_STEPS,
          f"{label} training: {kernel} launched {fwd} forward and {bwd} backward in "
          f"{TRAIN_STEPS} steps, not {2 * per_step} and {per_step} a step")
    timed = [h["seconds"] for h in history[2:]]
    step_ms = 1e3 * sum(timed) / len(timed)
    step_fn = make_train_step(model, opt_cfg, TRAIN_MICRO)
    batch = run["pipe"].batch_at(TRAIN_STEPS)
    t0 = time.perf_counter()
    busy_ms, top, port, events = device_busy(lambda: step_fn(run["state"], batch), host=False)
    traced_ms = 1e3 * (time.perf_counter() - t0)
    check(busy_ms is not None, f"{label} training: the traced step holds no device event")
    return {
        "steps": history, "held_out_loss": {"before": held_before, "after": held_after},
        "step_ms": step_ms, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        "peak_gb": run["peak_gb"], "forward_per_step": fwd // TRAIN_STEPS,
        "backward_per_step": bwd // TRAIN_STEPS,
        # the profiler's own host cost stretches the traced step's wall, so
        # the busy share is the device's busy time over an untraced step's
        "traced": {"wall_ms": traced_ms, "busy_ms": busy_ms, "busy_share": busy_ms / step_ms,
                   "events": events, "top": top, "port": port},
    }


def log_trained(tag: str, label: str, kernel: str, out: dict) -> None:
    """(c)'s and (g)'s lines: each step, then the run's figures."""
    tr = out["traced"]
    for h in out["steps"]:
        log(f"train ({tag}): step {h['step']}: loss {h['loss']:.6f}, grad_norm "
            f"{h['grad_norm']:.6f}, lr {h['lr']:.6g}, {1e3 * h['seconds']:.1f} ms")
    log(f"train ({tag}): {label} at full width ({TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, "
        f"{TRAIN_MICRO} microbatches, remat): {out['step_ms']:.1f} ms a step (steps "
        f"3-{TRAIN_STEPS}), {out['tokens_per_s']:.0f} tokens/s, peak {out['peak_gb']:.2f} GB; "
        f"{kernel} launches a step {out['forward_per_step']} forward, "
        f"{out['backward_per_step']} backward; traced step: device busy {tr['busy_ms']:.1f} ms, "
        f"{tr['busy_share']:.3f} of an untraced step ({tr['wall_ms']:.1f} ms wall under the "
        f"profiler), {tr['events']} device events; top "
        f"{[(n, round(ms, 2)) for n, ms in tr['top']]}; port kernels "
        f"{ {k: (round(e['ms'], 2), e['launches']) for k, e in tr['port'].items() if '<' not in k} }")
    held = out["held_out_loss"]
    log(f"train ({tag}): the batch of pipeline step {TRAIN_HELD_OUT_STEP}, not trained on: "
        f"loss {held['before']:.6f} before the {TRAIN_STEPS} steps, {held['after']:.6f} after")


def train_seeds_phase() -> dict:
    """``--train-seeds``: (c)'s 6 steps from each of :data:`TRAIN_SEEDS`'
    initial states, and which gate holds in each; then (d)'s and (i)'s
    card-against-CPU checks from each (:func:`card_against_cpu`)."""
    import torch

    from repro_torch.configs import config_for, smoke_config_for
    from repro_torch.models import build_model

    cfg = config_for("granite3_2b")
    model = build_model(cfg)
    out = {}
    for seed in TRAIN_SEEDS:
        history: list = []
        run = six_steps(model, cfg, seed, history)
        before, after = run["held_out_before"], run["held_out_after"]
        losses = [h["loss"] for h in history]
        out[seed] = {"losses": losses, "held_out_before": before, "held_out_after": after,
                     "last_below_first": losses[-1] < losses[0],
                     "held_out_falling": after < before}
        log(f"train seeds: seed {seed}: {json.dumps(out[seed])}")
        del run
        gc.collect()
        torch.cuda.empty_cache()
    del model
    for seed in TRAIN_SEEDS:
        for arch, seq_len, control in (("granite3_2b", 32, _flash_dk_zeroed),
                                       ("mamba2_370m", 96, _ssd_ddtA_zeroed)):
            figures = card_against_cpu(f"train seeds: seed {seed} smoke {arch}",
                                       smoke_config_for(arch), seq_len, control, seed)
            out[seed][f"{arch}_smoke"] = {k: v for k, v in figures.items() if k != "losses"}
    return out


def granite_training(cfg) -> tuple[dict, dict]:
    """(c): granite-3-2b at full width, random weights from seed 0, through
    ``train_loop`` on the card; the traced step; the first step with the
    kernels against the plain attention swapped in.  Returns the figures
    and the captured backward inputs."""
    import torch

    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.flash_attention import flash_attention as fa_binding
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import attention as ATT
    from repro_torch.models import build_model
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_loop import init_state, make_train_step

    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    captured: dict = {}
    original = _capture_flash_backward(captured)
    history: list = []
    try:
        run = six_steps(model, cfg, 0, history)
    finally:
        fa_binding.flash_attention_bwd_cuda = original
    out = trained_figures("granite", "flash_attention", model, cfg, opt_cfg, run, history)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # the first step on one 1,024-token sequence: kernels, then the plain
    # attention (differentiated by autograd) swapped in
    state0 = init_state(model, torch.Generator("cuda").manual_seed(0), opt_cfg)
    one = DataPipeline(batch=1, seq_len=1024, vocab=cfg.vocab).batch_at(0)
    first = make_train_step(model, opt_cfg, 1)
    _, mk = first(state0, one)
    kernel = {"loss": float(mk["loss"]), "grad_norm": float(mk["grad_norm"])}
    flash = ATT.flash_attention
    ATT.flash_attention = lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw)
    try:
        _, mp = first(state0, one)
    finally:
        ATT.flash_attention = flash
    plain = {"loss": float(mp["loss"]), "grad_norm": float(mp["grad_norm"])}
    rel = {key: abs(kernel[key] - plain[key]) / abs(plain[key]) for key in kernel}
    for key, tol in KERNEL_VS_PLAIN_TOL.items():
        check(rel[key] <= tol, f"granite first step at 1,024 tokens: kernel {key} "
              f"{kernel[key]} against plain {plain[key]}: {rel[key]} over {tol}")
    del state0, one, first, mk, mp
    gc.collect()
    torch.cuda.empty_cache()

    log_trained("c", "granite-3-2b", "flash_attention", out)
    log(f"train (c): first step at 1,024 tokens, kernels against the plain attention: loss "
        f"{kernel['loss']:.6f} / {plain['loss']:.6f} (rel {rel['loss']:.3g}, limit "
        f"{KERNEL_VS_PLAIN_TOL['loss']}), grad_norm {kernel['grad_norm']:.6f} / "
        f"{plain['grad_norm']:.6f} (rel {rel['grad_norm']:.3g}, limit "
        f"{KERNEL_VS_PLAIN_TOL['grad_norm']})")
    out["kernel_vs_plain"] = {"kernel": kernel, "plain": plain, "rel": rel}
    return out, captured


@contextlib.contextmanager
def _flash_dk_zeroed():
    """(d)'s control: the flash backward's dK replaced by zeros."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa_binding

    original = fa_binding.flash_attention_bwd_cuda

    def zeroed(*args, **kw):
        dq, dk, dv = original(*args, **kw)
        return dq, torch.zeros_like(dk), dv

    fa_binding.flash_attention_bwd_cuda = zeroed
    try:
        yield
    finally:
        fa_binding.flash_attention_bwd_cuda = original


@contextlib.contextmanager
def _ssd_ddtA_zeroed():
    """(i)'s control: the ssd backward's ddtA replaced by zeros."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_binding

    original = ssd_binding.ssd_scan_bwd_cuda

    def zeroed(*args):
        dxdt, ddtA, dB, dC = original(*args)
        return dxdt, torch.zeros_like(ddtA), dB, dC

    ssd_binding.ssd_scan_bwd_cuda = zeroed
    try:
        yield
    finally:
        ssd_binding.ssd_scan_bwd_cuda = original


def card_against_cpu(label: str, cfg, seq_len: int, control, seed: int = 0) -> dict:
    """(d)'s and (i)'s first check: ``cfg`` from one initial tree (drawn on
    the CPU from ``seed``, moved to the card) over the same pipeline batches of 4 x
    ``seq_len`` tokens, 8 steps on the CPU, on the card, and on the card
    under ``control`` (a context in which one kernel's gradient is zeroed).
    Each step's loss within :data:`SMOKE_LOSS_TOL` and the final parameters
    within 2e-2; the loss gaps and the parameters' moves within
    :data:`SMOKE_MOVE_TOL`, which the control must fail."""
    import torch

    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.dist.sharding import to_device
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import TrainState, train_loop
    from repro_torch.tree import tree_leaves

    tree = init_params(torch.Generator("cpu").manual_seed(seed), cfg, "cpu")
    initial = [t.clone() for t in tree_leaves(tree)]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)

    def pipe(device):
        return DataPipeline(batch=4, seq_len=seq_len, vocab=cfg.vocab, seed=1, device=device)

    def run(device):
        params = to_device(tree, device)
        history: list = []
        final = train_loop(build_model(cfg, device),
                           TrainState(params, adamw_init(params, opt_cfg), None),
                           iter(pipe(device)), opt_cfg, steps=8, log_every=0, history=history)
        return ([h["loss"] for h in history],
                [t.cpu() - t0 for t, t0 in zip(tree_leaves(final.params), initial)])

    losses, moves = {}, {}
    for name in ("cpu", "cuda"):
        losses[name], moves[name] = run(name)
    with control():
        losses["control"], moves["control"] = run("cuda")
    cpu_model, batches = build_model(cfg, "cpu"), pipe("cpu")
    start = [held_out_loss(cpu_model, tree, batches.batch_at(s)) for s in range(8)]
    moved = max(abs(a - b) for a, b in zip(losses["cpu"], start))

    def figures(name):
        return {
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses[name], losses["cpu"])),
            "param_max_diff": max(float((a - b).abs().max())
                                  for a, b in zip(moves[name], moves["cpu"])),
            "loss_gap_of_move": max(abs(a - b) for a, b in zip(losses[name], losses["cpu"]))
            / moved,
            "move_rel": max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                            for a, b in zip(moves[name], moves["cpu"])),
        }

    card, ctl = figures("cuda"), figures("control")
    check(card["loss_rel"] <= SMOKE_LOSS_TOL, f"{label} card vs CPU: per-step loss rel "
          f"{card['loss_rel']} over {SMOKE_LOSS_TOL}: {losses}")
    check(card["param_max_diff"] <= 2e-2, f"{label} card vs CPU: final parameters differ by "
          f"{card['param_max_diff']}, over 2e-2")
    check(card["loss_gap_of_move"] <= SMOKE_MOVE_TOL["loss"], f"{label} card vs CPU: loss "
          f"gap {card['loss_gap_of_move']} of the steps' largest move {moved}, over "
          f"{SMOKE_MOVE_TOL['loss']}")
    check(card["move_rel"] <= SMOKE_MOVE_TOL["move"], f"{label} card vs CPU: a leaf's move "
          f"differs by {card['move_rel']} of the CPU's, over {SMOKE_MOVE_TOL['move']}")
    check(ctl["move_rel"] > SMOKE_MOVE_TOL["move"], f"{label} card vs CPU: the control's "
          f"moves read {ctl['move_rel']}, inside {SMOKE_MOVE_TOL['move']}: the check cannot "
          f"see a zeroed gradient")
    log(f"{label} card vs CPU over 8 steps at 4 x {seq_len} tokens: max per-step loss rel "
        f"{card['loss_rel']:.3g} (limit {SMOKE_LOSS_TOL}; card "
        f"{[round(x, 5) for x in losses['cuda']]}), final parameters max |diff| "
        f"{card['param_max_diff']:.3g} (limit 2e-2); loss gap {card['loss_gap_of_move']:.3g} of "
        f"the steps' largest move {moved:.4g} (limit {SMOKE_MOVE_TOL['loss']}), parameter "
        f"moves {card['move_rel']:.3g} of the CPU's (limit {SMOKE_MOVE_TOL['move']}); control "
        f"({control.__name__}): loss gap {ctl['loss_gap_of_move']:.3g}, moves "
        f"{ctl['move_rel']:.3g}")
    return {"losses": losses, "loss_move": moved, **card, "control": ctl}


def smoke_training(cfg, tmp: pathlib.Path) -> dict:
    """(d): the smoke config from one initial tree (drawn on the CPU, moved
    to the card) over the same pipeline batches: 8 steps card against CPU;
    microbatches 2 against 1; compression converging on a repeated batch;
    a checkpoint at step 4 restored and continued to step 8 against the
    uninterrupted run; and the launcher twice over one ``--ckpt``."""
    import torch

    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.dist.compress import init_error_tree
    from repro_torch.dist.sharding import to_device
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import TrainState, make_train_step, train_loop
    from repro_torch.tree import tree_leaves

    tree = init_params(torch.Generator("cpu").manual_seed(0), cfg, "cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)

    def fresh(device, compress=False):
        params = to_device(tree, device)
        return TrainState(params, adamw_init(params, opt_cfg),
                          init_error_tree(params) if compress else None)

    def pipe(device, batch=4):
        return DataPipeline(batch=batch, seq_len=32, vocab=cfg.vocab, seed=1, device=device)

    against_cpu = card_against_cpu("train (d): smoke granite", cfg, 32, _flash_dk_zeroed)
    models = {d: build_model(cfg, d) for d in ("cpu", "cuda")}
    batch = pipe("cuda", batch=8).batch_at(0)
    s1, m1 = make_train_step(models["cuda"], opt_cfg, 1)(fresh("cuda"), batch)
    s2, m2 = make_train_step(models["cuda"], opt_cfg, 4)(fresh("cuda"), batch)
    micro_loss = abs(float(m1["loss"]) - float(m2["loss"])) / abs(float(m1["loss"]))
    micro_param = float((tree_leaves(s1.params)[0] - tree_leaves(s2.params)[0]).abs().max())
    check(micro_loss <= 2e-2 and micro_param <= 2e-2,
          f"smoke microbatches 4 vs 1 on the card: loss rel {micro_loss}, first leaf "
          f"{micro_param} (limits 2e-2, the reference's)")

    state = fresh("cuda", compress=True)
    step = make_train_step(models["cuda"], opt_cfg, compress=True)
    fixed = pipe("cuda").batch_at(0)
    compressed = []
    for _ in range(8):
        state, m = step(state, fixed)
        compressed.append(float(m["loss"]))
    check(compressed[-1] < compressed[0] and all(math.isfinite(x) for x in compressed),
          f"smoke compressed training on a repeated batch does not converge: {compressed}")
    check(any(float(e.abs().max()) > 0 for e in tree_leaves(state.ef_error)),
          "smoke compressed training: the error-feedback residuals are all zero")

    ckpt = tmp / "resume"
    mgr = CheckpointManager(str(ckpt), keep_n=3)
    whole = train_loop(models["cuda"], fresh("cuda"), iter(pipe("cuda")), opt_cfg, steps=8,
                       checkpoint_mgr=mgr, checkpoint_every=4, log_every=0)
    mgr.wait()
    restored = mgr.restore(4, device="cuda")
    p = pipe("cuda")
    resumed = train_loop(models["cuda"], TrainState(restored["params"], restored["opt"]),
                         (p.batch_at(s) for s in range(4, 8)), opt_cfg, steps=8, log_every=0)
    resume_diff = max(float((a - b).abs().max()) for a, b in
                      zip(tree_leaves(resumed.params), tree_leaves(whole.params)))
    check(resume_diff == 0.0, f"smoke checkpoint at step 4, restored and continued to step "
          f"8: params differ from the uninterrupted run by {resume_diff}")

    launcher_dir = tmp / "launcher"
    outs = []
    for steps in (4, 6):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite3_2b",
             "--smoke", "--steps", str(steps), "--batch", "4", "--seq", "32",
             "--checkpoint-every", "2", "--ckpt", str(launcher_dir)],
            capture_output=True, text=True, timeout=300, cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        check(proc.returncode == 0, f"launcher --steps {steps}: rc {proc.returncode}\n"
              f"{proc.stdout}\n{proc.stderr}")
        outs.append(proc.stdout)
    check("done at step 4" in outs[0] and "resuming from checkpoint step 4" in outs[1]
          and "done at step 6" in outs[1], f"launcher twice over one --ckpt: {outs}")
    log(f"train (d): smoke granite microbatches 4 vs 1: loss rel {micro_loss:.3g}, first leaf {micro_param:.3g} (limits "
        f"2e-2); compressed on a repeated batch {compressed[0]:.4f} -> {compressed[-1]:.4f}; "
        f"checkpoint at step 4 restored and continued: step-8 params bit-equal; launcher "
        f"resumed from step 4 to 6")
    return {"card_against_cpu": against_cpu, "micro_loss_rel": micro_loss,
            "micro_first_leaf": micro_param, "compressed": compressed,
            "resume_max_diff": resume_diff}


#: (label, B, Hq, Hk, S, D, kwargs): training layers whose backward (e)
#: also times, from random inputs: phi3-mini-3.8b's (MHA, D = 96, on the
#: tensor cores) and gemma3-12b's global layer (D = 256, two warpgroups a
#: block)
FLASH_BWD_TIMED = [("phi3_mini_38b", 2, 32, 32, 4096, 96, dict(causal=True)),
                   ("gemma3_12b_global", 2, 16, 8, 4096, 256, dict(causal=True))]


def random_backward_inputs(B: int, Hq: int, Hk: int, S: int, D: int, kw: dict,
                           seed: int) -> tuple:
    """bf16 q, k, v and dO from a seed, and the forward kernel's o and lse."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((B, Hq, S, D), generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn((B, Hk, S, D), generator=g, device="cuda").bfloat16() for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    return q, k, v, o, lse, do


def time_flash_backward(label: str, args: tuple, kw: dict) -> dict:
    """(e): one backward call's times: the three kernels together by CUDA
    events and each apart by CUDA events between its launches
    (:func:`pass_split_ms`), the bound (5 products of 2 D operations per
    valid pair at the bf16 peak, against each input read once and each
    gradient written once) and TFLOP/s on that count,
    ``scaled_dot_product_attention``'s forward + backward minus its forward,
    the plain backward, and the forward with lse against without."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_plan, flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    q, k, v, o, lse, do = args
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    rel = max(rel_err(a, b) for a, b in zip(got, want))
    max_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    check(rel <= FLASH_BWD_TOL["bfloat16"], f"flash backward at {label}'s training inputs: "
          f"{rel} over {FLASH_BWD_TOL['bfloat16']}")
    del got, want
    torch.cuda.empty_cache()

    def bwd():
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)

    k1, k2 = cuda_ms(bwd, reps=10), cuda_ms(bwd, reps=10)
    split = pass_split_ms(backward_plan(q, k, v, o, lse, do, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **kw), reps=3,
                       warmup=1)
    torch.cuda.empty_cache()
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), do)

    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa_fwd, reps=10)
    lib_both = cuda_ms(sdpa_fwd_bwd, reps=10)
    fwd_plain = cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=10)
    fwd_lse = cuda_ms(lambda: flash_attention_cuda(q, k, v, return_lse=True, **kw), reps=10)
    pairs = valid_pairs(Sq, Sk, kw.get("causal", True), kw.get("window"),
                        kw.get("q_offset", 0)) * B * Hq
    ops_count = 5 * 2 * D * pairs
    nbytes = (3 * q.numel() * q.element_size() + 4 * k.numel() * k.element_size()
              + lse.numel() * lse.element_size())
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_count / BF16_OPS_PER_S * 1e3
    out = {
        "shape": [B, Hq, k.shape[1], Sq, Sk, D], "dtype": str(q.dtype), "kwargs": kw,
        "ms": min(k1, k2), "split_ms": split, "plain_ms": plain_ms,
        "library_ms": lib_both - lib_fwd, "library_forward_ms": lib_fwd,
        "library_forward_backward_ms": lib_both,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "ops": ops_count, "bytes": nbytes, "pairs": pairs,
        "tflops": ops_count / (min(k1, k2) * 1e-3) / 1e12,
        "forward_ms": fwd_plain, "forward_lse_ms": fwd_lse,
        "max_abs_err": max_abs, "max_rel_err": rel,
    }
    log(f"train (e): flash backward at {label}'s training inputs {out['shape']} bf16 "
        f"{kw}: {out['ms']:.3f} ms ({out['tflops']:.2f} TFLOP/s of the 5-product count; by "
        f"kernel { {n: round(t, 3) for n, t in split.items()} } ms), bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}: {ops_count / 1e9:.1f} GFLOP at 989 "
        f"TFLOP/s, {nbytes / 1e6:.1f} MB), plain {plain_ms:.3f} ms, SDPA backward "
        f"{out['library_ms']:.3f} ms (forward + backward {lib_both:.3f} - forward "
        f"{lib_fwd:.3f}); forward {fwd_plain:.3f} ms, with lse {fwd_lse:.3f} ms; == plain "
        f"(max |diff| / max |plain| {rel:.3g})")
    return out


#: ssd_scan's backward against ``ssd_scan_bwd_ref`` in float64, per
#: gradient, max |kernel - plain| over max |plain|: float32 products and
#: sums in another order.  With every exponent from one float64 chunk
#: cumsum (C11), the worst over (f)'s 25 draws was 9.6e-6 (ddtA), 2.9e-6
#: (dxdt), and at mamba2-370m's training shape at |dtA| up to 50 1.5e-6;
#: with a float32 cumsum it was 7.2e-5, and up to 1.55e-4 on the survey's
#: draws (NVIDIA H100 80GB HBM3, 700.00 W); the start was 1e-3
SSD_BWD_TOL = 1e-4
#: (BH, BG, L, P, N, largest |dtA| a step): the forward sweep's shapes
#: (:data:`SSD_CASES`), mamba2-370m's training inputs (B = 2 a microbatch:
#: 64 heads, 2 groups, 4,096 rows), and the same at the decays its A =
#: -1..-16 gives at dt ~0.7 and at dt ~3, where exp(cum) leaves float32's
#: range within a chunk; 3 heads a group (one short slice of
#: ``ssd_bwd_chunk_dbc``'s 8) and 12 (a full slice and a short one), and
#: N = 256 (four of the kernels' N tiles), both ragged
SSD_BWD_CASES = ([(*case, 0.5) for case in SSD_CASES]
                 + [(64, 2, 4096, 64, 128, a) for a in (0.5, 12.0, 50.0)]
                 + [(12, 4, 300, 64, 128, 0.5), (24, 2, 300, 64, 128, 0.5),
                    (8, 2, 200, 64, 256, 0.5)])


#: (BH, BG, L, P, N): mamba2-370m's training-step inputs, a microbatch of 2
#: x 4,096 tokens (32 heads of 64 on one group of state 128 a sequence)
SSD_BWD_TIMED = (64, 2, 4096, 64, 128)
#: the draws (seed, largest |dtA| a step) at :data:`SSD_BWD_TIMED`, each
#: from a generator of its own seed: at strong decays a float32 chunk
#: cumsum put dxdt and ddtA over SSD_BWD_TOL on some of them (ROADMAP C11,
#: closed by the kernels' float64 sums).  (f) gates them beside
#: :data:`SSD_BWD_CASES`; ``--ssd-bwd-times`` reads them in whatever tree
#: it runs in, without gating, so that a parent's kernels read too
SSD_BWD_SURVEY = tuple((seed, amax) for seed in (32, 33, 34, 35, 36) for amax in (12.0, 50.0))

SSD_GRAD_NAMES = ("dxdt", "ddtA", "dB", "dC")


def ssd_bwd_gated_draws() -> list[tuple]:
    """(f)'s draws in order, each (BH, BG, L, P, N, largest |dtA|, seed):
    :data:`SSD_BWD_CASES` from one generator seeded 31 (seed None), then
    :data:`SSD_BWD_SURVEY`'s draws at :data:`SSD_BWD_TIMED`, each from a
    generator of its own seed, as ``--ssd-bwd-times`` draws them."""
    return ([(*case, None) for case in SSD_BWD_CASES]
            + [(*SSD_BWD_TIMED, amax, seed) for seed, amax in SSD_BWD_SURVEY])


def ssd_bwd_inputs(g, BH: int, BG: int, L: int, P: int, N: int, amax: float):
    """xdt, dtA (each step in [-amax, -0.01]), B, C and dy on the card from
    the generator ``g``."""
    import torch

    xdt = torch.randn((BH, L, P), generator=g, device="cuda") * 0.5
    dtA = -(0.01 + (amax - 0.01) * torch.rand((BH, L), generator=g, device="cuda"))
    B = torch.randn((BG, L, N), generator=g, device="cuda") * 0.3
    C = torch.randn((BG, L, N), generator=g, device="cuda") * 0.3
    dy = torch.randn((BH, L, P), generator=g, device="cuda")
    return xdt, dtA, B, C, dy


def ssd_backward_checks() -> dict:
    """(f): the backward kernels against ``ssd_scan_bwd_ref`` in float64 at
    :func:`ssd_bwd_gated_draws`, each gradient within :data:`SSD_BWD_TOL` of its
    max |plain|; dy one position off must read outside the limit on every
    gradient (a control); two launches give the same bits; and
    ``ops.ssd_scan`` on model-layout inputs that require grad, inside a
    non-reentrant checkpoint, launching the forward twice and the backward
    once, against torch autograd of the plain version on the CPU."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import plan, ssd_scan_bwd_cuda

    names = SSD_GRAD_NAMES
    g = torch.Generator(device="cuda").manual_seed(31)
    errs, max_abs = {}, 0.0
    for BH, BG, L, P, N, amax, seed in ssd_bwd_gated_draws():
        label = f"BH={BH} BG={BG} L={L} P={P} N={N} |dtA|<={amax}"
        if seed is not None:
            label += f" seed {seed}"
        draw = g if seed is None else torch.Generator(device="cuda").manual_seed(seed)
        xdt, dtA, B, C, dy = ssd_bwd_inputs(draw, BH, BG, L, P, N, amax)
        fw = plan(xdt, dtA, B, C, BH // BG)
        for _, launch in fw.passes:
            launch()
        args = (xdt, dtA, B, C, BH // BG, fw.states, fw.decay, fw.cbt, fw.y)
        got = ssd_scan_bwd_cuda(*args, dy)
        again = ssd_scan_bwd_cuda(*args, dy)
        shifted = ssd_scan_bwd_cuda(*args, torch.roll(dy, 1, dims=1)) if L > 1 else None
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"ssd backward at {label}: two launches differ")
        want = ssd_scan_bwd_ref(*(t.double() for t in (xdt, dtA, B, C)), BH // BG,
                                dy.double())
        rel = {n: rel_err(a.double(), b) for n, a, b in zip(names, got, want)}
        for n, a, b in zip(names, got, want):
            check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                  f"ssd backward at {label}: {n} shape or not finite")
            check(rel[n] <= SSD_BWD_TOL, f"ssd backward at {label}: {n} max |kernel - plain| "
                  f"/ max |plain| {rel[n]} over {SSD_BWD_TOL}")
            max_abs = max(max_abs, float((a.double() - b).abs().max()))
        control = None
        if shifted is not None:
            control = {n: rel_err(a.double(), b) for n, a, b in zip(names, shifted, want)}
            check(min(control.values()) > SSD_BWD_TOL, f"ssd backward at {label}: dy one "
                  f"position off reads within the limit: {control}")
        errs[label] = {"rel": rel, "control": control}
        log(f"train (f): ssd backward at {label}: max |kernel - plain| / max |plain| "
            f"{ {n: float(f'{e:.3g}') for n, e in rel.items()} }; dy one position off "
            f"{ {n: float(f'{e:.3g}') for n, e in (control or {}).items()} }; bit-equal")
        del xdt, dtA, B, C, dy, fw, args, got, again, shifted, want
        torch.cuda.empty_cache()

    rng = np.random.default_rng(31)
    arrs = (rng.normal(size=(2, 300, 8, 64)), rng.uniform(0.05, 0.3, size=(2, 300, 8)),
            -rng.uniform(0.1, 1.0, size=(8,)), rng.normal(size=(2, 300, 2, 128)) * 0.3,
            rng.normal(size=(2, 300, 2, 128)) * 0.3)
    weight = rng.normal(size=(2, 300, 8, 64))

    def grads(device):
        ins = [torch.as_tensor(a, dtype=torch.float32, device=device).requires_grad_()
               for a in arrs]
        w = torch.as_tensor(weight, dtype=torch.float32, device=device)
        checkpoint(lambda *t: (ssd_ops.ssd_scan(*t) * w).sum(), *ins,
                   use_reentrant=False).backward()
        return [t.grad.cpu() for t in ins]

    fwd, bwd = ssd_ops.LAUNCHES, ssd_ops.BACKWARD_LAUNCHES
    card = grads("cuda")
    check(ssd_ops.LAUNCHES == fwd + 2 and ssd_ops.BACKWARD_LAUNCHES == bwd + 1,
          f"ssd autograd under checkpoint: {ssd_ops.LAUNCHES - fwd} forward and "
          f"{ssd_ops.BACKWARD_LAUNCHES - bwd} backward launches, not 2 and 1")
    autograd = max(rel_err(a, b) for a, b in zip(card, grads("cpu")))
    check(autograd <= FLASH_AUTOGRAD_TOL, f"ssd autograd.Function under checkpoint against "
          f"the CPU's autograd: {autograd} over {FLASH_AUTOGRAD_TOL}")
    worst = {n: max(e["rel"][n] for e in errs.values()) for n in names}
    log(f"train (f): ssd backward == ssd_scan_bwd_ref (float64) at {len(errs)} cases, worst "
        f"{ {n: float(f'{e:.3g}') for n, e in worst.items()} } (limit {SSD_BWD_TOL}); each "
        f"bit-equal across two launches; autograd.Function under checkpoint vs the CPU's "
        f"autograd {autograd:.3g} (limit {FLASH_AUTOGRAD_TOL})")
    return {"cases": errs, "worst": worst, "max_abs_err": max_abs, "autograd": autograd}


def _capture_ssd_backward(store: dict):
    """Wrap the ssd backward binding so that its first call's inputs are
    kept (clones): the training path's own inputs for (h).  Returns the
    original, to put back."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_binding

    original = ssd_binding.ssd_scan_bwd_cuda

    def capture(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy):
        if not store:
            store["args"] = tuple(t.clone() for t in (xdt, dtA, B, C, states, decay, cbt, y,
                                                      dy))
            store["n_rep"] = n_rep
        return original(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy)

    ssd_binding.ssd_scan_bwd_cuda = capture
    return original


def mamba_training(cfg) -> tuple[dict, dict]:
    """(g): mamba2-370m at full width and depth, random weights from seed
    0, through ``train_loop`` on the card as (c) runs granite
    (:func:`trained_figures`: 2 x 48 forward and 48 backward ssd launches a
    microbatch, ms a step, tokens/s, peak GB, a traced step; the held-out
    batch's loss read, and read again after the same steps with the float64
    plain ssd backward in the kernels' place, neither gated); then the
    first step's gradients against that plain backward's
    (:func:`mamba_gradient_check`).  Returns the figures and the captured
    backward inputs."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_binding
    from repro_torch.models import build_model
    from repro_torch.train.optim import AdamWConfig

    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    captured: dict = {}
    original = _capture_ssd_backward(captured)
    history: list = []
    try:
        run = six_steps(model, cfg, 0, history)
    finally:
        ssd_binding.ssd_scan_bwd_cuda = original
    out = trained_figures("mamba", "ssd_scan", model, cfg, opt_cfg, run, history,
                          held_out_gate=False)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    log_trained("g", "mamba2-370m", "ssd_scan", out)
    # the same six steps with exact ssd gradients: the held-out loss's
    # move under them, beside the kernels' (read, not gated)
    history = []
    ssd_binding.ssd_scan_bwd_cuda = _plain64_ssd_backward
    try:
        run = six_steps(model, cfg, 0, history)
    finally:
        ssd_binding.ssd_scan_bwd_cuda = original
    out["held_out_loss_plain64"] = {"before": run["held_out_before"],
                                    "after": run["held_out_after"]}
    log(f"train (g): the same {TRAIN_STEPS} steps with the float64 plain ssd backward in the "
        f"kernels' place: held-out loss {run['held_out_before']:.6f} before, "
        f"{run['held_out_after']:.6f} after (the kernels': {out['held_out_loss']['after']:.6f})")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["gradients"] = mamba_gradient_check(model, cfg)
    return out, captured


def _plain64_ssd_backward(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy):
    """The ssd backward binding's signature and result, from
    ``ssd_scan_bwd_ref`` in float64 (rounded to float32 at the end)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref

    grads = ssd_scan_bwd_ref(*(t.double() for t in (xdt, dtA, B, C)), n_rep, dy.double())
    return tuple(t.float().contiguous() for t in grads)


#: (g)'s gradient check, per leaf of mamba2-370m's tree, max |kernels -
#: plain| over max |plain|: the first step's gradients in float32 compute
#: with the ssd backward kernels against the same with the float64 plain
#: backward in their place.  Float32 sums in another order, 3xTF32, and
#: ddtA's row terms rounded in float32 and summed within each chunk, carried
#: through 48 layers into A_log and dt_bias, the leaves that sum ddtA over a
#: sequence.  Measured 3.3e-4 (A_log; the float32 plain backward 2.0e-5 there,
#: the ddtA-zeroed control 1.75; NVIDIA H100 80GB HBM3, 700.00 W)
MAMBA_GRAD_TOL = 1e-3


def mamba_gradient_check(model, cfg) -> dict:
    """(g)'s check of the gradients themselves.  Six steps at lr <= 1e-3
    do not move mamba2-370m's held-out loss past its noise (bf16 compute;
    (g) reads it with the kernels and with exact ssd gradients, and gates
    here instead).  Seed 0's initial state, the first training batch (2
    microbatches, remat), float32 compute: each leaf's gradient with the
    ssd backward kernels within :data:`MAMBA_GRAD_TOL` of the same with
    ``ssd_scan_bwd_ref`` in float64 in their place; the kernels with ddtA
    zeroed (the control) must put some leaf outside."""
    import torch

    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import transformer
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_loop import init_state
    from repro_torch.tree import tree_leaves, tree_unflatten

    binding = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    state = init_state(model, torch.Generator("cuda").manual_seed(0), AdamWConfig())
    batch = DataPipeline(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab).batch_at(0)
    kernels = binding.ssd_scan_bwd_cuda

    def ddtA_zeroed(*args):
        dxdt, ddtA, dB, dC = kernels(*args)
        return dxdt, torch.zeros_like(ddtA), dB, dC

    def grads(backward):
        binding.ssd_scan_bwd_cuda = backward
        leaves = [p.detach().float().requires_grad_(True) for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        n = TRAIN_BATCH // TRAIN_MICRO
        for i in range(TRAIN_MICRO):
            model.loss_fn(params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()},
                          remat=True).backward()
        return [p.grad for p in leaves]

    def worst(got, want):
        return max(float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
                   for a, b in zip(got, want))

    compute = transformer.COMPUTE_DTYPE
    transformer.COMPUTE_DTYPE = torch.float32
    try:
        want = grads(_plain64_ssd_backward)
        got = worst(grads(kernels), want)
        control = worst(grads(ddtA_zeroed), want)
    finally:
        transformer.COMPUTE_DTYPE = compute
        binding.ssd_scan_bwd_cuda = kernels
    del want, state
    gc.collect()
    torch.cuda.empty_cache()
    check(got <= MAMBA_GRAD_TOL, f"mamba training: the first step's gradients with the ssd "
          f"backward kernels, float32 compute: a leaf {got} of its max off the float64 plain "
          f"backward's, over {MAMBA_GRAD_TOL}")
    check(control > MAMBA_GRAD_TOL, f"mamba training: with ddtA zeroed the gradients read "
          f"within the limit ({control})")
    log(f"train (g): mamba2-370m's first-step gradients (float32 compute, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches) with the ssd backward kernels "
        f"against the float64 plain backward in their place: worst leaf max |diff| / max "
        f"|plain| {got:.3g} (limit {MAMBA_GRAD_TOL}); ddtA zeroed {control:.3g}")
    return {"worst_leaf": got, "control": control}


def time_ssd_backward(captured: dict) -> dict:
    """(h): one backward call at (g)'s captured inputs: checked against the
    float64 plain backward, timed whole by CUDA events and by kernel
    (:func:`pass_split_ms`), beside the float32 plain backward
    (``ssd_scan_bwd_ref``), the bound of this data (:func:`ssd_bwd_bound`),
    each kernel's own (:func:`ssd_bwd_kernel_bounds`) and the forward at
    the same inputs; no PyTorch call computes it."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import backward_plan, plan, ssd_scan_bwd_cuda

    xdt, dtA, B, C, states, decay, cbt, y, dy = captured["args"]
    n_rep = captured["n_rep"]
    BH, L, P = xdt.shape
    BG, N = B.shape[0], B.shape[2]
    got = ssd_scan_bwd_cuda(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy)
    want = ssd_scan_bwd_ref(*(t.double() for t in (xdt, dtA, B, C)), n_rep, dy.double())
    rel = max(rel_err(a.double(), b) for a, b in zip(got, want))
    max_abs = max(float((a.double() - b).abs().max()) for a, b in zip(got, want))
    check(rel <= SSD_BWD_TOL, f"ssd backward at mamba's training inputs: {rel} over "
          f"{SSD_BWD_TOL}")
    del got, want
    torch.cuda.empty_cache()

    def bwd():
        return ssd_scan_bwd_cuda(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy)

    k1, k2 = cuda_ms(bwd, reps=10), cuda_ms(bwd, reps=10)
    call = backward_plan(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy)
    split = pass_split_ms(call)
    scratch = call.scratch_bytes()
    del call
    plain_ms = cuda_ms(lambda: ssd_scan_bwd_ref(xdt, dtA, B, C, n_rep, dy), reps=3, warmup=1)
    torch.cuda.empty_cache()
    forward_ms = cuda_ms(lambda: [launch() for _, launch in plan(xdt, dtA, B, C,
                                                                 n_rep).passes], reps=10)
    ops_count, nbytes = ssd_bwd_bound(BH, BG, L, P, N)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_count / F32_OPS_PER_S * 1e3
    out = {
        "shape": [BH, BG, L, P, N], "ms": min(k1, k2), "split_ms": split, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "ops": ops_count, "bytes": nbytes, "tflops": ops_count / (min(k1, k2) * 1e-3) / 1e12,
        "forward_ms": forward_ms, "scratch_bytes": scratch,
        "max_abs_err": max_abs, "max_rel_err": rel,
        "kernel_bounds": ssd_bwd_kernel_bounds(BH, BG, L, P, N),
    }
    log(f"train (h): ssd backward at mamba's training inputs {out['shape']}: {out['ms']:.3f} "
        f"ms ({out['tflops']:.2f} TFLOP/s of the recurrence's count), bound {out['bound_ms']:.4f} "
        f"ms ({out['bound_by']}: {ops_count / 1e9:.2f} GFLOP at 67 TFLOP/s, {nbytes / 1e6:.1f} "
        f"MB), plain (float32) {plain_ms:.3f} ms, forward {forward_ms:.3f} ms; scratch "
        f"{scratch / 1e6:.1f} MB; == plain (max |diff| / max |plain| {rel:.3g})")
    for line in ssd_bwd_split_lines(split, out["kernel_bounds"]):
        log(f"train (h): {line}")
    return out


def ssd_bwd_split_lines(split: dict[str, float], bounds: dict[str, dict]) -> list[str]:
    """One line a backward kernel: its ms beside its own bound."""
    lines = []
    for name, ms in split.items():
        b = bounds[name]
        tc = f", {b['tf32x3_ms']:.4f} at 3xTF32's 165 TFLOP/s" if b["tf32x3_ms"] else ""
        lines.append(f"{name} {ms:.4f} ms, own bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
                     f"{b['ops'] / 1e9:.2f} GFLOP at 67 TFLOP/s{tc}; {b['bytes'] / 1e6:.1f} MB)")
    return lines


def ssd_bwd_times_phase() -> dict:
    """``--ssd-bwd-times``: ssd_scan's backward at :data:`SSD_BWD_TIMED`
    from seed 32, at |dtA| up to 0.5 and 50: held to the float64 plain
    backward within :data:`SSD_BWD_TOL` and timed whole and by kernel, each
    beside its own bound; then its error over :data:`SSD_BWD_SURVEY`'s
    draws, not gated (train (f) gates them); the forward's time at
    :data:`SSD_SERVING_TIMED` and at :data:`SSD_BWD_TIMED`; and a
    mamba2-370m training step's (:func:`mamba_step_ms`).  It reads the kernels from the binding's
    ``BACKWARD_PASSES`` and passes the forward's y only where the binding's
    ``backward_plan`` takes it, so a copy of this script in an unpacked
    parent tree times the parent's kernels the same way.  It fails, after
    printing everything, if a timed case is over the limit."""
    import inspect

    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref

    # by path: the package's own ``ssd_scan`` is the ops function
    binding = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    BH, BG, L, P, N = SSD_BWD_TIMED
    n_rep = BH // BG
    takes_y = "y" in inspect.signature(binding.backward_plan).parameters
    bounds = ssd_bwd_kernel_bounds(BH, BG, L, P, N)
    ops_count, nbytes = ssd_bwd_bound(BH, BG, L, P, N)

    def run(g, amax):
        """The inputs of one draw, the backward's arguments and its error."""
        xdt, dtA, B, C, dy = ssd_bwd_inputs(g, BH, BG, L, P, N, amax)
        fw = binding.plan(xdt, dtA, B, C, n_rep)
        for _, launch in fw.passes:
            launch()
        args = (xdt, dtA, B, C, n_rep, fw.states, fw.decay, fw.cbt,
                *((fw.y,) if takes_y else ()), dy)
        got = binding.ssd_scan_bwd_cuda(*args)
        want = ssd_scan_bwd_ref(*(t.double() for t in (xdt, dtA, B, C)), n_rep, dy.double())
        return args, {n: rel_err(a.double(), b) for n, a, b in zip(SSD_GRAD_NAMES, got, want)}

    g = torch.Generator(device="cuda").manual_seed(32)
    out = {"tree": str(ROOT), "shape": list(SSD_BWD_TIMED),
           "kernels": list(binding.BACKWARD_PASSES), "kernel_bounds": bounds,
           "bound_ms": max(ops_count / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
           "cases": {}, "survey": {}}
    for amax in (0.5, 50.0):
        args, rel = run(g, amax)
        call = binding.backward_plan(*args)
        split = pass_split_ms(call, reps=20)
        scratch = call.scratch_bytes()
        del call
        ms = min(cuda_ms(lambda: binding.ssd_scan_bwd_cuda(*args), reps=20) for _ in range(2))
        out["cases"][f"|dtA|<={amax}"] = {"rel": rel, "ms": ms, "split_ms": split,
                                          "scratch_bytes": scratch}
        log(f"--ssd-bwd-times ({ROOT}) at {list(SSD_BWD_TIMED)}, |dtA| <= {amax}: {ms:.4f} ms "
            f"whole (bound {out['bound_ms']:.4f}), scratch {scratch / 1e6:.1f} MB; max |kernel "
            f"- plain| / max |plain| { {n: float(f'{e:.3g}') for n, e in rel.items()} }")
        for line in ssd_bwd_split_lines(split, bounds):
            log(f"--ssd-bwd-times:   {line}")
        del args
        torch.cuda.empty_cache()
    for seed, amax in SSD_BWD_SURVEY:
        _, rel = run(torch.Generator(device="cuda").manual_seed(seed), amax)
        out["survey"][f"seed {seed} |dtA|<={amax}"] = rel
        log(f"--ssd-bwd-times ({ROOT}) survey, seed {seed}, |dtA| <= {amax}: max |kernel - "
            f"plain| / max |plain| { {n: float(f'{e:.3g}') for n, e in rel.items()} }")
        torch.cuda.empty_cache()
    worst = {n: max(r[n] for r in out["survey"].values()) for n in SSD_GRAD_NAMES}
    out["survey_worst"] = worst
    out["forward"] = {}
    for label, (fBH, fBG, fL, fP, fN) in (("serving", SSD_SERVING_TIMED),
                                          ("training", SSD_BWD_TIMED)):
        # seed 37, |dtA| up to 0.5: held to the plain chunked form and
        # timed as the serving path's captured call is
        xdt, dtA, B, C, _ = ssd_bwd_inputs(torch.Generator(device="cuda").manual_seed(37),
                                           fBH, fBG, fL, fP, fN, 0.5)
        f = out["forward"][label] = time_ssd(((xdt, dtA, B, C, fBH // fBG), {}))
        log(f"--ssd-bwd-times ({ROOT}) forward at {label} inputs {f['shape']}: {f['ms']:.4f} "
            f"ms; max |kernel - plain| / max |plain| {f['max_rel_err']:.3g}")
        del xdt, dtA, B, C
        torch.cuda.empty_cache()
    out["step"] = mamba_step_ms()
    log(f"--ssd-bwd-times ({ROOT}) mamba2-370m training step ({TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, {TRAIN_MICRO} microbatches, remat): {out['step']['step_ms']:.1f} ms a step, "
        f"steps 3-{TRAIN_STEPS}, losses {[round(x, 4) for x in out['step']['losses']]}")
    log(f"--ssd-bwd-times ({ROOT}) survey over {len(SSD_BWD_SURVEY)} draws, worst "
        f"{ {n: float(f'{e:.3g}') for n, e in worst.items()} } (not gated here, gated in "
        f"train (f); limit {SSD_BWD_TOL})")
    for label, case in out["cases"].items():
        check(max(case["rel"].values()) <= SSD_BWD_TOL, f"--ssd-bwd-times at {label}: "
              f"{case['rel']} over {SSD_BWD_TOL}")
    return out


#: (BH, BG, L, P, N): mamba2-370m's first serving batch, 4 prompts padded
#: to 1,819 tokens (32 heads of 64 on one group of state 128 a prompt)
SSD_SERVING_TIMED = (128, 4, 1819, 64, 128)


def mamba_step_ms() -> dict:
    """``--ssd-bwd-times``: mamba2-370m at full width and depth, (g)'s
    :func:`six_steps` from seed 0; ms a step over steps 3 on (host clock
    around each step)."""
    import torch

    from repro_torch.configs import config_for
    from repro_torch.models import build_model

    cfg = config_for("mamba2_370m")
    history: list = []
    run = six_steps(build_model(cfg), cfg, 0, history)
    losses = [h["loss"] for h in history]
    check(all(math.isfinite(x) for x in losses), f"--ssd-bwd-times mamba step: losses {losses}")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    timed = [h["seconds"] for h in history[2:]]
    return {"step_ms": 1e3 * sum(timed) / len(timed), "losses": losses}


def mamba_smoke_training(cfg) -> dict:
    """(i): mamba2-370m's smoke config card against CPU over 8 steps at
    batches of 96 tokens (two of the kernels' chunks), with ddtA zeroed as
    the control (:func:`card_against_cpu`)."""
    return card_against_cpu("train (i): smoke mamba", cfg, 96, _ssd_ddtA_zeroed)


def train_phase() -> dict:
    """Training on the card (ROADMAP A16.1, A16.2): (a) the flash backward
    against its plain version; (b) the data pipeline; (c) granite-3-2b at
    full width through ``train_loop``; (d) the smoke config card against
    CPU, microbatches, compression, checkpoint resume and the launcher; (e)
    the backward's times at granite's training inputs and at
    :data:`FLASH_BWD_TIMED`'s layers; (f) the ssd backward against its
    plain version; (g) mamba2-370m at full width through ``train_loop``;
    (h) the ssd backward's times at (g)'s inputs; (i) mamba's smoke config
    card against CPU."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import config_for, smoke_config_for

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = config_for("granite3_2b")
    out = {"flash_backward": flash_backward_checks()}
    out["pipeline"] = train_pipeline_check(cfg.vocab)
    out["granite"], captured = granite_training(cfg)
    out["backward_times"] = time_flash_backward("granite3_2b", captured["args"],
                                                captured["kw"])
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    out["backward_shapes"] = {}
    for i, (label, B, Hq, Hk, S, D, kw) in enumerate(FLASH_BWD_TIMED):
        args = random_backward_inputs(B, Hq, Hk, S, D, kw, seed=30 + i)
        out["backward_shapes"][label] = time_flash_backward(label, args, kw)
        del args
        gc.collect()
        torch.cuda.empty_cache()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        out["smoke"] = smoke_training(smoke_config_for("granite3_2b"), tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["ssd_backward"] = ssd_backward_checks()
    out["mamba"], captured = mamba_training(config_for("mamba2_370m"))
    gc.collect()
    torch.cuda.empty_cache()
    out["ssd_backward_times"] = time_ssd_backward(captured)
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    out["mamba_smoke"] = mamba_smoke_training(smoke_config_for("mamba2_370m"))
    out["seconds"] = time.perf_counter() - t0
    log(f"train phase ok in {out['seconds']:.1f} s")
    return out


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    card = card_name_and_power()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.ssd_scan import BACKWARD_PASSES

    if sys.argv[1:] == ["--flash-digest"]:
        digests = flash_kernel_phase(digest_only=True)["digests"]
        print(json.dumps({"card": card, "tree": str(ROOT), "flash_digests": digests}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--flash-variants"]:
        print(json.dumps({"card": card, "flash_variants": flash_variants_phase()}), flush=True)
        return 0
    if sys.argv[1:] == ["--relagg-variants"]:
        print(json.dumps({"card": card, "relagg_variants": relagg_variants_phase()}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--relagg-times"]:
        times = relagg_times_phase()
        for label, t in times.items():
            log(relagg_times_line(label, t))
        print(json.dumps({"card": card, "tree": str(ROOT), "relagg": times}), flush=True)
        return 0
    if sys.argv[1:] == ["--ssd-bwd-times"]:
        _build.load("ssd_scan")
        print(json.dumps({"card": card, "ssd_bwd_times": ssd_bwd_times_phase()}), flush=True)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        _build.load("relagg")
        out = mesh_phase()
        print(json.dumps({"card": card, "cards": torch.cuda.device_count(), "mesh": out},
                         default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--train-seeds"]:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            list(pool.map(_build.load, ("flash_attention", "ssd_scan")))
        print(json.dumps({"card": card, "tree": str(ROOT), "train_seeds": train_seeds_phase()}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--train"]:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            list(pool.map(_build.load, ("flash_attention", "ssd_scan")))
        out = train_phase()
        print(json.dumps({"card": card, "train": out}, default=str), flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))  # one nvcc per source, together
    log(f"build: {', '.join(k + '.cu' for k in KERNELS)} in {time.perf_counter() - t0:.1f} s")
    build = build_report()

    t0 = time.perf_counter()
    kern = kernel_phase()
    flash = flash_kernel_phase()
    ssd = ssd_kernel_phase()
    log(f"kernel phase: {kern['cases']} relagg, {flash['cases']} flash_attention and "
        f"{ssd['cases']} ssd_scan cases ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    main, session = main_path_phase()
    log(f"main path phase ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    q12 = time_relagg("Q12", capture_relagg_args(session, "Q12"))
    q5 = time_relagg("Q5", capture_relagg_args(session, "Q5"))
    for label, t in (("Q12", q12), ("Q5", q5)):
        log(f"relagg at {label}'s inputs (n={t['n']}, G={t['groups']}, k={t['k']}, "
            f"mask set on {t['mask_set']}, {t['selected']} rows selected, {t['path']} "
            f"path): == plain (max abs err {t['max_abs_err']:.3g}, "
            f"{t['max_err_over_abs_sum']:.3g} of its group's sum of |v|); kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, index_add_ "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bytes'] / 1e6:.3f} MB / 3.35 TB/s; {t['sector_bytes'] / 1e6:.3f} MB "
            f"in 32-byte sectors, {t['sector_bound_ms']:.5f} ms)")
        log(relagg_times_line(label, t))
    log(f"times phase ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    froid_warm = {name: main["times"][f"{name}/udf/relagg_on_warm_ms"]
                  for name in QUERY_NAMES}
    iterative = iterative_phase(session, froid_warm)
    scan_sync = scan_mode_sync_check(session)
    t1 = time.perf_counter()
    cursor = cursor_phase()
    log(f"cursor-loop phase ok in {time.perf_counter() - t1:.1f} s")
    correlated = correlated_phase(session)
    invocation = invocation_phase(session)
    policy_axis = routed_policy_axis(session)
    del session
    gc.collect()
    torch.cuda.empty_cache()
    fused = fused_phase()
    gc.collect()
    torch.cuda.empty_cache()
    routed = routed_phase(policy_axis)
    gc.collect()
    torch.cuda.empty_cache()
    fleet = fleet_phase()
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_phase()
    log(f"iterative phase ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cross_device_phase()
    log(f"cross-device phase ok in {time.perf_counter() - t0:.1f} s")

    # lm_times: per serving path ("granite3_2b", "gemma3_12b/window", ...)
    serving, lm_times = {}, {}

    def time_captured(arch: str, kernel: str, capture, path_of) -> None:
        t0 = time.perf_counter()
        for kind, args in sorted(capture.calls.items()):
            path = path_of(kind)
            if kernel == "flash_attention":
                # every row of a call without the causal mask reaches the
                # middle key tile: the control holds over all rows there
                t = time_flash(args, all_rows_control=(arch == "granite3_2b"
                                                       or not args[1].get("causal", True)))
            else:
                t = time_ssd(args)
            # the run's launches of this kind of call
            t = lm_times[path] = {**t, "kernel": kernel, "launches": capture.counts[kind]}
            lib = (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
                   else "none (no PyTorch call computes it)")
            mask = f" {t['kwargs']}" if kernel == "flash_attention" else ""
            log(f"{kernel} at {path}'s serving inputs {t['shape']}{mask} "
                f"({t['launches']} launches in the first run): == plain (max abs err "
                f"{t['max_abs_err']:.3g}); kernel {t['ms']:.4f} ms ({t['tflops']:.2f} "
                f"TFLOP/s), plain {t['plain_ms']:.4f} ms, library {lib}, bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}: {t['ops'] / 1e9:.3f} GFLOP, "
                f"{t['bytes'] / 1e6:.3f} MB)")
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{kernel} times ok in {time.perf_counter() - t0:.1f} s")

    for arch, kernel, n_runs in SERVE_ARCHS:
        t0 = time.perf_counter()
        serving[arch], capture = serving_phase(arch, kernel, n_runs)
        log(f"serving phase {arch} ok in {time.perf_counter() - t0:.1f} s")
        time_captured(arch, kernel, capture,
                      lambda kind: arch if len(capture.calls) == 1 else f"{arch}/{kind}")
        del capture
    # the models that attend to a memory (A18): one prefill and 31 decode
    # steps each, then flash at each kind of call they made
    for arch, repeats in CROSS_SERVE:
        t0 = time.perf_counter()
        serving[arch], capture = cross_serving_phase(arch, repeats)
        log(f"serving phase {arch} ok in {time.perf_counter() - t0:.1f} s")
        time_captured(arch, "flash_attention", capture, lambda kind: f"{arch}/{kind}")
        del capture

    t0 = time.perf_counter()
    lm_cross = lm_cross_device_phase()
    log(f"LM cross-device phase ok in {time.perf_counter() - t0:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase()
    bt, sbt = train["backward_times"], train["ssd_backward_times"]

    log(json.dumps({"main_path_warm_ms": main["times"], "iterative": iterative,
                    "scan_sync": scan_sync, "cursor": cursor, "correlated": correlated,
                    "invocation": invocation, "fused": fused, "routed": routed,
                    "fleet": fleet, "mesh": mesh,
                    "relagg_q5": q5,
                    "relagg_q12": q12, "serving": serving, "lm_kernels": lm_times,
                    "lm_cross_device_moe": lm_cross["moe"],
                    "lm_cross_device_cross": lm_cross["cross"],
                    "train": train,
                    "flash_sweep": flash, "ssd_sweep": ssd, "build": build}, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    fa, sd = lm_times["granite3_2b"], lm_times["mamba2_370m"]
    flash_paths = {path: t for path, t in lm_times.items() if t["kernel"] == "flash_attention"}
    print(json.dumps({"kernels": [
        {"name": "relagg", "route": "cuda", "source": "src/repro_torch/csrc/relagg.cu",
         "replaces": "src/repro/kernels/relagg/relagg.py:36",
         "launches": main["launches"],
         "max_abs_err": max(kern["max_abs_err"], q12["max_abs_err"], q5["max_abs_err"]),
         "ms": q12["ms"], "plain_ms": q12["plain_ms"], "bound_ms": q12["bound_ms"],
         "bound_by": q12["bound_by"], "library_ms": q12["library_ms"],
         "device_ms": q12["device_ms"], "ok": True,
         # INTERPRETED's and HEKATON's statements on the cut sessions only,
         # the count set to 0 before each statement (FROID's runs not counted)
         "launches_iterative": iterative["relagg_launches"],
         # the cursor-loop phase's grouped query over a loop UDF's output
         # (FROID, pallas_agg on), the count set to 0 just before it
         "launches_cursor": cursor["oracle"]["relagg_launches"],
         # the correlated phase's (b) at SF 1 (FROID, pallas_agg on): the
         # batched launches, the count set to 0 just before it, and the
         # batched call's times at (b)'s inputs
         "launches_correlated": correlated["sf1"]["grouped/relagg_on"]["relagg_batched_launches"],
         "correlated": {key: correlated["sf1"]["relagg_batched"][key] for key in (
             "B", "n", "groups", "k", "path", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "bound_per_item_ms", "library_ms", "max_abs_err")},
         # the invocation phase, the counts set to 0 just before each call:
         # (a) one launch an execute_many call at each N (the decorrelated
         # build is unbatched; the serial loop launches once a ticket), (b)
         # one batched launch an execute_many call of 16 dates
         "launches_invocation": {
             **{f"key_total/execute_many/N{n}": row["execute_many"]["relagg_launches"]
                for n, row in invocation["key_total"]["sweep"].items()},
             **{f"key_total/serial/N{n}": row["serial"]["relagg_launches"]
                for n, row in invocation["key_total"]["sweep"].items()},
             "grouped/execute_many_batched":
                 invocation["grouped"]["relagg_on"]["relagg_batched_launches_per_call"]},
         # the fused phase, the counts set to 0 just before each drain: the
         # decorrelated build over detail once a fused wave, once a
         # key_total statement when each statement drains on its own
         "launches_fused": {
             f"{queue}/{arm}_per_drain": fused[queue][arm]["relagg_launches"]
             for queue in ("mixed", "overlap") for arm in ("fused", "perstmt")},
         # the routed phase, the count set to 0 just before each routed
         # drain: relagg's launches a drain by the arm the router picked
         # (the routing queue holds one key_total statement, the overlap
         # queue six)
         "launches_routed": {
             f"{queue}/{arm}_per_drain": n for queue in ("routing", "overlap")
             for arm, n in routed[queue]["relagg_launches"].items()},
         # the fleet phase, the count set to 0 just before each: (a) session
         # B's first call of Q5 and Q12, each a store hit; (d) each drain of
         # the warm-started routed fleet (two workers, two host threads);
         # (c) the two-thread check's launches
         "launches_fleet": {
             **{f"tpch_store_hit/{n}": fleet["tpch"]["B_relagg_launches"][n]
                for n in ("Q5", "Q12")},
             **{f"routed_fresh_fleet/drain{i}": d["relagg_launches"]
                for i, d in enumerate(fleet["routing"]["fresh_fleet"])},
             "two_threads": fleet["relagg_threads"]["launches"]},
         # the mesh phase, the count set to 0 just before each timed call:
         # (a) an execute_many call of key_total unsharded, and sharded over
         # cuda:0 named 2 and 4 times (one unbatched launch a shard)
         "launches_mesh": {
             f"key_total/{label}/N{n}": r["relagg_launches_per_call"]
             for n, row in mesh["key_total"].items() for label, r in row.items()
             if isinstance(r, dict)}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
         "launches": serving["granite3_2b"]["launches"],
         "max_abs_err": max(flash["max_abs_err_f32"], flash["max_abs_err_bf16"],
                            *(t["max_abs_err"] for t in flash_paths.values())),
         "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"], "ok": True,
         # every serving path's own run: its launches, and the times at the
         # inputs it handed the kernel (head dims 64, 96, 128, 256); the
         # cross models' paths by kind of call (encoder, self, cross,
         # decode_cross)
         "paths": [{"path": path, "head_dim": t["shape"][5], "launches": t["launches"],
                    "causal": t["kwargs"].get("causal", True),
                    "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"]} for path, t in flash_paths.items()],
         # the cross models' runs (prefill and 31 decode steps), the count
         # set to 0 just before each
         "launches_cross": {arch: serving[arch]["launches"] for arch, _ in CROSS_SERVE},
         # the backward kernels (no TPU counterpart: the reference
         # differentiates its plain attention), timed at granite-3-2b's
         # training inputs; launches a training step of granite-3-2b
         # (each launch the three kernels), the counts set to 0 just before
         # the run
         "backward": {
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "none: src/repro/kernels/flash_attention/ops.py:38-48 differentiates "
                         "the plain attention (the reference has no backward kernel)",
             "ms": bt["ms"], "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"],
             "library_ms": bt["library_ms"], "plain_ms": bt["plain_ms"],
             "max_abs_err": max(bt["max_abs_err"], train["flash_backward"]["max_abs_err"]),
             "split_ms": bt["split_ms"], "tflops": bt["tflops"],
             # HGMMA instructions of the tensor-core instances (bf16), from
             # the build report
             "hgmma": {name.split("::")[-1]: r["hgmma"] for name, r in build.items()
                       if any(kernel in name for kernel in FLASH_BWD_TC)},
             # phi3-mini-3.8b's and gemma3-12b's layer shapes, random inputs
             "shapes": {label: {key: t[key] for key in (
                 "shape", "ms", "split_ms", "tflops", "bound_ms", "bound_by", "library_ms",
                 "plain_ms", "max_abs_err")} for label, t in train["backward_shapes"].items()},
             "launches_train": train["granite"]["backward_per_step"],
             "launches_train_forward": train["granite"]["forward_per_step"]}},
        {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:36",
         "launches": serving["mamba2_370m"]["launches"],
         "max_abs_err": max(ssd["max_abs_err"], sd["max_abs_err"]),
         "ms": sd["ms"], "plain_ms": sd["plain_ms"], "bound_ms": sd["bound_ms"],
         "bound_by": sd["bound_by"], "library_ms": None, "ok": True,
         # the backward kernels (no TPU counterpart: the reference
         # differentiates its plain chunked form), timed at mamba2-370m's
         # training inputs; launches a training step of mamba2-370m (each
         # launch the backward's kernels), the counts set to 0 just before
         # the run
         "backward": {
             "kernels": list(BACKWARD_PASSES),
             "source": "src/repro_torch/csrc/ssd_scan.cu",
             "replaces": "none: src/repro/kernels/ssd_scan/ops.py:44-48 differentiates the "
                         "plain chunked form or the recurrence (the reference has no backward "
                         "kernel)",
             "ms": sbt["ms"], "bound_ms": sbt["bound_ms"], "bound_by": sbt["bound_by"],
             "library_ms": None, "plain_ms": sbt["plain_ms"],
             "max_abs_err": max(sbt["max_abs_err"], train["ssd_backward"]["max_abs_err"]),
             "split_ms": sbt["split_ms"], "tflops": sbt["tflops"],
             # each kernel's own bound (ops, bytes, bound_ms, tf32x3_ms)
             "kernel_bounds": sbt["kernel_bounds"],
             # TF32 HMMA instructions of the tensor-core kernels, from the
             # build report
             "hmma_tf32": {name.split("::")[-1]: r["hmma_tf32"] for name, r in build.items()
                           if r["source"] == "ssd_scan.cu"},
             "launches_train": train["mamba"]["backward_per_step"],
             "launches_train_forward": train["mamba"]["forward_per_step"],
             # registers and spills, from the build report
             "ptxas": {name.split("::")[-1]: {k: r[k] for k in (
                 "registers", "smem", "spill_stores", "spill_loads")}
                 for name, r in build.items() if r["source"] == "ssd_scan.cu"}}},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
