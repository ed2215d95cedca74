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
   tensor-core instructions (HGMMA, from ``cuobjdump -sass``); a bf16
   flash_attention instance without HGMMA fails (D = 16, 64, 96, 128,
   256), and so does a spill in the bf16 instances at D = 96 and 256, an
   ssd_scan kernel that spills or a set of ssd_scan kernels other than its
   four passes;
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
   at the grouped statement's inputs timed;
7. serving — granite-3-2b, mamba2-370m, phi3-mini-3.8b (head dim 96)
   and gemma3-12b (head dim 256, 1,024-token windows on 40 of its 48
   layers) at their published widths and depths, one after the other,
   through ``ServeEngine.run`` with Froid-compiled admission on the card:
   8 requests with 512-2048-token prompts plus one 33,000-token prompt
   that the ``admit`` rule rejects, served twice (granite, mamba) or once
   (phi3, gemma3), with the kernel launches counted over the first run,
   the peak device memory, and a traced prefill's port kernels checked by
   name and count (the bf16 flash kernel at the model's head dim, the four
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
   and gemma3's at their published head dims, 96 and 256, beside the same
   with the plain version in place of the kernel on the card) and the
   admission verdicts on the CPU and on the card.

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


def hgmma_counts(lib: pathlib.Path, tool: pathlib.Path) -> dict[str, int]:
    """Tensor-core instructions (HGMMA) per kernel in the library's SASS."""
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def flash_head_dim(name: str) -> int:
    """D of a bf16 flash_attention instance, from its demangled name
    (``tc::flash_fwd_bf16<(int)96>``) or its mangled one
    (``flash_fwd_bf16ILi96E``)."""
    m = re.search(r"flash_fwd_bf16(?:<(?:\(int\))?|ILi)(\d+)", name)
    check(m is not None, f"no head dim in the kernel name {name}")
    return int(m.group(1))


def build_report() -> dict[str, dict]:
    """Per kernel instance of the three libraries: ``ptxas -v``'s registers,
    shared memory and spills, and the HGMMA count of its SASS.  Fails
    unless each bf16 flash_attention instance (D = 16, 64, 96, 128, 256)
    holds tensor-core instructions, or if those at D = 96 and 256 spill."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
    from repro_torch.kernels.ssd_scan.ssd_scan import PASSES

    bindir = pathlib.Path(_build._nvcc()).parent
    report = {}
    for kernel in KERNELS:
        text = _build.build_log(kernel)
        for line in text.splitlines():
            if "warning" in line.lower() or "wgmma" in line.lower():
                log(f"ptxas {kernel}.cu: {line.strip()}")
        res = ptxas_report(text)
        hgmma = hgmma_counts(_build.library_path(kernel), bindir / "cuobjdump")
        mangled = sorted(res)
        for m, name in zip(mangled, demangle(mangled, bindir / "cu++filt")):
            r = report[name] = {**res[m], "hgmma": hgmma.get(m, 0), "source": f"{kernel}.cu"}
            log(f"ptxas {name} ({kernel}.cu): {r['registers']} registers, {r['smem']} bytes "
                f"static shared memory, spill stores {r['spill_stores']} / loads "
                f"{r['spill_loads']} bytes; HGMMA instructions in its SASS: {r['hgmma']}")
    bf16 = {flash_head_dim(n): r for n, r in report.items() if "flash_fwd_bf16" in n}
    check(sorted(bf16) == list(HEAD_DIMS), f"expected the bf16 flash_attention instances "
          f"D = {HEAD_DIMS}: {sorted(bf16)}")
    check(all(r["hgmma"] for r in bf16.values()),
          f"a bf16 flash_attention instance has no HGMMA: {bf16}")
    check(all(bf16[D]["spill_stores"] == 0 and bf16[D]["spill_loads"] == 0 for D in (96, 256)),
          f"a bf16 flash_attention instance at D = 96 or 256 spills: {bf16}")
    ssd = {n.split("::")[-1]: r for n, r in report.items() if r["source"] == "ssd_scan.cu"}
    check(set(ssd) == set(PASSES), f"ssd_scan.cu's kernels {sorted(ssd)}, expected "
          f"{list(PASSES)}")
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in ssd.values()),
          f"an ssd_scan kernel spills: {ssd}")
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
#: mix); phi3 and gemma3 are served once, to keep the script in its time
SERVE_ARCHS = (("granite3_2b", "flash_attention", 2), ("mamba2_370m", "ssd_scan", 2),
               ("phi3_mini_38b", "flash_attention", 1), ("gemma3_12b", "flash_attention", 1))
#: archs whose smoke config runs at its published head dim in the LM
#: cross-device phase (D = 96 and 256, the flash instances only they take)
PUBLISHED_HEAD_DIM = ("phi3_mini_38b", "gemma3_12b")
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
    gemma3-12b's head dims (96, 256) follow, from a second generator."""
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
    return {"cases": len(cases) + len(wide) + n_empty, "max_abs_err_f32": max_err[f32],
            "max_abs_err_bf16": max_err[bf16]}


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


def ssd_rel_err(a, b) -> float:
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)


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

    # (BH, BG, L, P, N): L = 1, under one chunk, ragged; mamba2-370m's
    # widths (one group for 32 heads) and its smoke; jamba-1.5's full widths
    # (P = N = 128, 8 groups) at the first serving batch's length and its
    # smoke (2 groups); more heads and groups than a grid's y axis holds
    # (65,535)
    cases = [(4, 4, 1, 64, 128), (8, 2, 40, 64, 128), (32, 1, 100, 64, 128),
             (32, 1, 2048, 64, 128), (4, 4, 2048, 64, 128), (8, 8, 100, 16, 16),
             (16, 8, 1819, 128, 128), (4, 2, 100, 16, 16), (70_000, 70_000, 80, 4, 4)]
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
        err, err_sp = ssd_rel_err(a, b), ssd_rel_err(a, y_sp)
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
    (BH, L, P), dim 2 for attention's q).  Kinds: ``"window"`` for an
    attention call with a window (gemma3's local layers), else ``"full"``."""

    def __init__(self, fn, seq_dim: int):
        self.fn, self.seq_dim = fn, seq_dim
        self.calls: dict[str, tuple] = {}
        self.counts: dict[str, int] = {}

    def __call__(self, *args, **kwargs):
        kind = "window" if kwargs.get("window") is not None else "full"
        self.counts[kind] = self.counts.get(kind, 0) + 1
        kept = self.calls.get(kind)
        if kept is None or args[0].shape[self.seq_dim] > kept[0][0].shape[self.seq_dim]:
            self.calls[kind] = (args, kwargs)
        return self.fn(*args, **kwargs)


def device_busy(fn) -> tuple[float | None, list, dict, int]:
    """Device time (ms) of what ``fn`` runs on the card, as the union of the
    intervals of the device events (kernels, copies) in a ``torch.profiler``
    trace, the five kernels with the most device time, and the port's own
    kernels by name (``flash_fwd_bf16``, ``flash_fwd_kernel``, ...) with
    their time and launches, a template instance also by its last integer
    argument (``flash_fwd_bf16<96>``, the head dim), and the number of
    device events.  (None, [], {}, 0) if the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, [], {}, 0
    busy, end, by_name, port = 0.0, float("-inf"), {}, {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        m = re.search(r"(flash_fwd_\w+|ssd_\w+|relagg_\w+)(<[^>]*>)?", name)
        if m:
            arg = re.findall(r"\d+", m.group(2) or "")
            for key in [m.group(1)] + ([f"{m.group(1)}<{arg[-1]}>"] if arg else []):
                entry = port.setdefault(key, {"ms": 0.0, "launches": 0})
                entry["ms"] += (b - a) / 1e3
                entry["launches"] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return busy / 1e3, [(name[:60], ms / 1e3) for name, ms in top], port, len(spans)


def busy_breakdown(model, reqs, expected) -> dict:
    """Device busy time of one prefill at the first batch's shape (the
    trace with more device events of two) and of 4 decode steps after it
    (profiled apart from the timed runs, whose host clock the profiler
    would inflate)."""
    import torch

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

    prefill()  # warm
    # a trace now and then loses a device event (a flash kernel of
    # gemma3-12b's prefill, in a full run of this script) and never adds
    # one: the readings and the checks on the prefill's kernels take the
    # more complete of two traces of it
    p_ms, p_top, p_port, _ = max((device_busy(prefill) for _ in range(2)), key=lambda r: r[3])
    d_ms, d_top, _, _ = device_busy(decode)
    del state
    return {"prefill_busy_ms": p_ms, "prefill_top": p_top, "prefill_port_kernels": p_port,
            "decode_busy_ms_per_step": None if d_ms is None else d_ms / 4,
            "decode_top": d_top}


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
        **busy,
    }
    for what, wall in (("prefill", timed.prefill_ms[0]),
                       ("decode", summary["decode_ms_per_token"])):
        ms = busy[f"{what}_busy_ms" if what == "prefill" else "decode_busy_ms_per_step"]
        summary[f"{what}_device_idle_share"] = None if ms is None else 1.0 - ms / wall
        log(f"{cfg.name} {what}: device busy "
            + ("not measured (no device events in the trace)" if ms is None else
               f"{ms:.2f} ms of {wall:.2f} ms (idle share {1.0 - ms / wall:.3f}); top "
               f"{[(n, round(t, 2)) for n, t in busy[what + '_top']]}"
               + (f"; port kernels {port}" if what == "prefill" else "")))
    walls = " s and ".join(f"{run['wall_s']:.2f}" for run in runs)
    log(f"{cfg.name}: served {len(reqs)} requests ({summary['rejected']} rejected by "
        f"admission, {generated} tokens) in {walls} s; prefill ms per batch "
        f"{[round(x, 1) for x in timed.prefill_ms]}, "
        f"decode {summary['decode_ms_per_token']:.2f} ms/token, "
        f"{summary['tokens_per_s']:.1f} tokens/s, peak {summary['peak_gb']:.2f} GB; "
        f"{kernel} launches {first['launches'][kernel]} per run ({capture.counts})"
        + (f"; greedy and sampled tokens equal across the {n_runs} runs" if later else ""))
    del model, engine, runs, first, later, second, timed
    gc.collect()
    torch.cuda.empty_cache()
    return summary, capture


def valid_pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int) -> int:
    """(query, key) pairs the attention mask lets through, per (b, head)."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window is not None else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


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
    (with the window as a boolean mask where there is one) and beside the
    bound of this data: 4 D operations per (query, key) pair the mask lets
    through at the bf16 tensor-core peak, against q, k, v and o moved once
    each (K and V once for the n_rep heads that share them).  In bf16 the
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
    sdpa_ok = causal and q_offset == 0 and Sq == Sk and kw.get("sm_scale") is None
    # the causal window as SDPA's boolean mask (True: attend); every row
    # keeps its own key, so no row is empty
    window_mask = None if window is None else _mask(Sq, Sk, True, window, 0, q.device)

    def library():
        if window_mask is not None:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=window_mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

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
    pairs = valid_pairs(Sq, Sk, causal, window, q_offset) * B * Hq
    ops_count = 4 * D * pairs
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_count / BF16_OPS_PER_S * 1e3
    return {
        "shape": [B, Hq, k.shape[1], Sq, Sk, D], "dtype": str(q.dtype), "kwargs": kw,
        "pairs": pairs, "ops": ops_count, "bytes": nbytes,
        "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "max_abs_err": err, "max_abs_err_f32": err32, "library_max_abs_err": lib_err,
        "mean_abs_err_vs_f32": mean_diff, "mean_limit": limit, "control_dropped_tile": control,
        "mean_abs_err_vs_f32_reach": mean_diff_r, "mean_limit_reach": limit_r,
        "control_dropped_tile_reach": control_r, "library_mean_abs_err_vs_f32": sdpa_mean,
        "tflops": ops_count / (min(k1, k2) * 1e-3) / 1e12,
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
    err = ssd_rel_err(out, ref)
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


def lm_cross_device_phase() -> None:
    """The smoke configs with the same parameters on the CPU and on the
    card: prefill logits, then 4 teacher-forced decode steps, within
    2e-2 x max|logit| (bf16 activations summed in another order); and the
    admission verdicts at the rules' edges, equal.  phi3's and gemma3's
    smoke configs take their published head dims (96, 256), so the card
    runs those flash instances; gemma3's 16-token window is shorter than
    the 24-token prompt, and its embeddings are tied.  Beside each of those
    two, the same run on the card with the plain version in place of the
    kernel (P in float32, never rounded to bf16) is read against the CPU:
    where the kernel's reading nears the tolerance, that tells its P
    rounding from the rest of the card's arithmetic."""
    import dataclasses

    import torch

    from repro_torch.configs import config_for, smoke_config_for
    from repro_torch.kernels.flash_attention import flash_attention as fa_binding
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.serve.admission import AdmissionPolicy

    def to_card(t):
        if isinstance(t, dict):
            return {k: to_card(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_card(v) for v in t]
        return t.to("cuda")

    def teacher_forced(model, device, toks, steps):
        """The prefill's logits and each decode step's, on the CPU."""
        logits, cache = model.prefill(toks.to(device), max_len=64)
        out = [logits.cpu()]
        for nt in steps:
            logits, cache = model.decode_step(cache, nt.to(device))
            out.append(logits.cpu())
        return out

    def worst(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    for arch, _, _ in SERVE_ARCHS:
        cfg = smoke_config_for(arch)
        if arch in PUBLISHED_HEAD_DIM:
            cfg = dataclasses.replace(cfg, head_dim=config_for(arch).head_dim)
        tree = T.init_params(torch.Generator("cpu").manual_seed(0), cfg, "cpu")
        models = {"cpu": build_model(cfg, "cpu").load(tree),
                  "card": build_model(cfg).load(to_card(tree))}
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
        steps = [torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32))
                 for _ in range(4)]
        cpu = teacher_forced(models["cpu"], "cpu", toks, steps)
        card = teacher_forced(models["card"], "cuda", toks, steps)
        tol = 2e-2 * float(cpu[0].abs().max())
        for step, (x, y) in enumerate(zip(cpu, card)):
            err = float((x - y).abs().max())
            what = "prefill" if step == 0 else f"decode {step - 1}"
            check(err <= tol, f"{cfg.name} smoke {what}: cpu vs card {err} > {tol}")
        plain = ""
        if arch in PUBLISHED_HEAD_DIM:
            kernel = fa_binding.flash_attention_cuda
            fa_binding.flash_attention_cuda = lambda q, k, v, **kw: flash_attention_ref(
                q, k, v, **kw)
            try:
                card_plain = teacher_forced(models["card"], "cuda", toks, steps)
            finally:
                fa_binding.flash_attention_cuda = kernel
            plain = (f"; with the plain version (P in float32) in place of the kernel on the "
                     f"card {worst(cpu, card_plain):.3g}")
        log(f"LM cross-device: {cfg.name} smoke (head dim {cfg.head_dim}) prefill + 4 decode "
            f"steps, cpu vs card max |diff| {worst(cpu, card):.3g} (tolerance {tol:.3g})"
            + plain)
    plen = [2048, 2049, 8192, 8193, 32768, 32769, 100, 5000]
    reqs = {"tier": np.array([0, 1, 2, 0, 1, 2, 0, 1]), "prompt_len": np.array(plen),
            "max_new_tokens": np.array([32, 5000, 300, 2000, 10, 10, 256, 1024]),
            "temperature": np.array([-0.1, 2.1, 0.0, 0.7, 1.0, 1.5, 2.0, 0.5])}
    a = AdmissionPolicy(device="cpu").evaluate(reqs)
    b = AdmissionPolicy().evaluate(reqs)
    for name in a:
        check(np.array_equal(a[name], b[name]), f"admission {name}: cpu {a[name]} vs card {b[name]}")
    log("LM cross-device: admission verdicts cpu == card")


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
    del session
    gc.collect()
    torch.cuda.empty_cache()
    log(f"iterative phase ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cross_device_phase()
    log(f"cross-device phase ok in {time.perf_counter() - t0:.1f} s")

    # lm_times: per serving path ("granite3_2b", "gemma3_12b/window", ...)
    serving, lm_times = {}, {}
    for arch, kernel, n_runs in SERVE_ARCHS:
        t0 = time.perf_counter()
        serving[arch], capture = serving_phase(arch, kernel, n_runs)
        log(f"serving phase {arch} ok in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for kind, args in sorted(capture.calls.items()):
            path = arch if len(capture.calls) == 1 else f"{arch}/{kind}"
            if kernel == "flash_attention":
                t = time_flash(args, all_rows_control=arch == "granite3_2b")
            else:
                t = time_ssd(args)
            # the first run's launches of this kind of call
            t = lm_times[path] = {**t, "kernel": kernel, "launches": capture.counts[kind]}
            lib = (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
                   else "none (no PyTorch call computes it)")
            log(f"{kernel} at {path}'s serving inputs {t['shape']} ({t['launches']} launches "
                f"in the first run): == plain (max abs err {t['max_abs_err']:.3g}); kernel "
                f"{t['ms']:.4f} ms ({t['tflops']:.2f} TFLOP/s), plain {t['plain_ms']:.4f} ms, "
                f"library {lib}, bound {t['bound_ms']:.5f} ms ({t['bound_by']}: "
                f"{t['ops'] / 1e9:.3f} GFLOP, {t['bytes'] / 1e6:.3f} MB)")
        del capture, args
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{kernel} times ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lm_cross_device_phase()
    log(f"LM cross-device phase ok in {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"main_path_warm_ms": main["times"], "iterative": iterative,
                    "scan_sync": scan_sync, "cursor": cursor, "correlated": correlated,
                    "relagg_q5": q5,
                    "relagg_q12": q12, "serving": serving, "lm_kernels": lm_times,
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
             "bound_by", "bound_per_item_ms", "library_ms", "max_abs_err")}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
         "launches": serving["granite3_2b"]["launches"],
         "max_abs_err": max(flash["max_abs_err_f32"], flash["max_abs_err_bf16"],
                            *(t["max_abs_err"] for t in flash_paths.values())),
         "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"], "ok": True,
         # every serving path's own run: its launches, and the times at the
         # inputs it handed the kernel (head dims 64, 96, 256)
         "paths": [{"path": path, "head_dim": t["shape"][5], "launches": t["launches"],
                    "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"]} for path, t in flash_paths.items()]},
        {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:36",
         "launches": serving["mamba2_370m"]["launches"],
         "max_abs_err": max(ssd["max_abs_err"], sd["max_abs_err"]),
         "ms": sd["ms"], "plain_ms": sd["plain_ms"], "bound_ms": sd["bound_ms"],
         "bound_by": sd["bound_by"], "library_ms": None, "ok": True},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
