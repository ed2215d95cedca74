#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU and the CUDA toolkit (``nvcc``); imports nothing of
JAX and nothing of the reference package.  Every phase must pass, or the
script exits non-zero:

1. build — compiles the port's CUDA kernel (``csrc/relagg.cu``) from the
   sources in this checkout;
2. kernels — the relagg kernel against its plain torch version on the card,
   on the shared-memory and the global-atomics path, with an empty mask and
   with out-of-range group ids;
3. main path — TPC-H at scale factor 1 (6,000,000 ``lineitem`` rows) on the
   card through ``Session.prepare`` / ``PreparedStatement.execute``: Q1,
   Q3, Q5, Q6, Q12 and Q14 in UDF and original form under FROID with
   ``pallas_agg`` on and off, cold then warm;
4. cross-device — the same queries at ``sf=0.01`` on the CPU and on the
   card;
5. times — relagg on the inputs the main path handed it for Q12 and Q5:
   checked against the plain version, then timed as the kernel, the plain
   version and one PyTorch call computing the same function, beside the
   bound that this data needs.

It prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the port's sources beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
#: H100 SXM data sheet: device-memory rate and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
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
    """(sums, sum of |v|, counts) per group in float64 on the host."""
    g = gid.cpu().numpy()
    sel = mask.cpu().numpy() & (g >= 0) & (g < groups)
    v = vals.cpu().numpy().astype(np.float64)[sel]
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
    sum and of the plain version — float atomics land in a run-dependent
    order, and float32 rounding grows with the magnitudes summed, not with
    the result."""
    from repro_torch.kernels.relagg import ops
    from repro_torch.kernels.relagg.ref import grouped_aggregate_ref
    from repro_torch.kernels.relagg.relagg import uses_shared

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
        max_err = max(max_err, float(err_plain.max(initial=0.0)))
        log(f"{label}: ok (max |kernel - plain| {float(err_plain.max(initial=0.0)):.3g})")
    check(paths == {"shared", "global"}, f"kernel paths covered: {sorted(paths)}")
    return {"cases": len(cases), "max_abs_err": max_err}


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


def run_statement(session, query, policy):
    """Prepare, execute cold, then warm ``WARM_ROUNDS`` times."""
    stmt = session.prepare(query, policy)
    cold = stmt.execute()
    check(not cold.cache_hit, "cold call reported a cache hit")
    warm = []
    for _ in range(WARM_ROUNDS):
        r = stmt.execute()
        check(r.cache_hit, "warm call missed the cache")
        warm.append(r.elapsed_s * 1e3)
    return cold, float(np.median(warm))


def main_path_phase(sf: float = 1.0) -> tuple[dict, object]:
    import torch

    import repro_torch.core as C
    from repro_torch.data.tpch import generate_tpch
    from repro_torch.data.tpch_udfs import QUERIES, register_udfs
    from repro_torch.kernels.relagg import ops

    session = C.Session()  # the card
    t0 = time.perf_counter()
    generate_tpch(session, sf=sf)
    register_udfs(session)
    torch.cuda.synchronize()
    resident = sum(t.nbytes() for t in session.catalog.values())
    log(f"TPC-H sf={sf}: {session.catalog['lineitem'].num_rows} lineitem rows, "
        f"{resident / 1e9:.3f} GB of columns on {session.device}, "
        f"generated and loaded in {time.perf_counter() - t0:.1f} s")

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


def time_relagg(label: str, args) -> dict:
    """Check the kernel against the plain version on the main path's own
    inputs, then time both and the library call.  The bound counts the
    bytes this data needs: every mask byte, gid where the mask is set, vals
    of selected rows, and the (G, k+1) output."""
    import torch

    from repro_torch.kernels.relagg.ref import grouped_aggregate_ref
    from repro_torch.kernels.relagg.relagg import relagg_cuda, uses_shared

    gid, mask, vals, G = args
    gid, mask, vals = gid.contiguous(), mask.contiguous(), vals.contiguous()
    n, k = vals.shape
    sel = mask & (gid >= 0) & (gid < G)

    ksums, kcounts = relagg_cuda(gid, mask, vals, G)
    psums, pcounts = grouped_aggregate_ref(gid, mask, vals, G)
    _, absum, ref_counts = f64_reference(gid, mask, vals, G)
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

    # turns: plain, kernel, kernel, plain; then the library call
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
    lib_ms = cuda_ms(library)
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
        "path": "shared" if uses_shared(G, k) else "global",
        "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bytes": nbytes, "sector_bytes": sector_bytes,
        "sector_bound_ms": sector_bytes / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": float(err.max(initial=0.0)),
        "max_err_over_abs_sum": float(np.max(err / np.maximum(absum, 1e-30),
                                             initial=0.0)),
    }


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

    t0 = time.perf_counter()
    _build.load("relagg")
    log(f"build: relagg.cu in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    kern = kernel_phase()
    log(f"kernel phase: {kern['cases']} cases ok in {time.perf_counter() - t0:.1f} s")

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
    del session
    torch.cuda.empty_cache()
    log(f"times phase ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cross_device_phase()
    log(f"cross-device phase ok in {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"main_path_warm_ms": main["times"], "relagg_q5": q5,
                    "relagg_q12": q12}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "relagg", "route": "cuda", "source": "src/repro_torch/csrc/relagg.cu",
        "replaces": "src/repro/kernels/relagg/relagg.py:36",
        "launches": main["launches"],
        "max_abs_err": max(kern["max_abs_err"], q12["max_abs_err"], q5["max_abs_err"]),
        "ms": q12["ms"], "plain_ms": q12["plain_ms"], "bound_ms": q12["bound_ms"],
        "bound_by": q12["bound_by"], "library_ms": q12["library_ms"], "ok": True,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
