"""Aggregate the dry run's JSON records into a summary and a roofline
table: a port of ``src/repro/launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report --dir experiments/dryrun_torch --table
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.roofline import PEAK_FLOPS

#: one H100's device memory, as ``nvidia-smi --query-gpu=name,memory.total
#: --format=csv,noheader`` reads it on the card ("NVIDIA H100 80GB HBM3,
#: 81559 MiB")
HBM_PER_CHIP = 81559 * 2**20


def load(dirname):
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def fmt_time(s):
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.1f}ms"
    return f"{s*1e6:.0f}µs"


def roofline_table(recs, mesh="16x16"):
    out = [
        "| arch | shape | mb | mem/chip GiB | fits | t_comp | t_mem | t_coll |"
        " dominant | t_model | MODEL/TRACED | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skip":
            out.append(
                f"| {r['arch']} | {r['shape']} |  |  |  |  |  |  | SKIP |  |  |"
                f" {r.get('reason','')} |"
            )
            continue
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} |  |  |  |  |  |  | FAIL |  |  |"
                f" {r.get('error','')[:60]} |"
            )
            continue
        roof = r["roofline"]
        mem = r["memory"]["per_device_total"]
        fits = "yes" if mem <= HBM_PER_CHIP else "NO"
        ratio = r.get("useful_flop_ratio")
        t_model = r.get("model_flops_per_chip", 0) / PEAK_FLOPS
        out.append(
            "| {arch} | {shape} | {mb} | {mem} | {fits} | {tc} | {tm} | {tl} |"
            " {dom} | {tmod} | {ratio} | |".format(
                arch=r["arch"], shape=r["shape"],
                mb=r.get("microbatches") or "",
                mem=fmt_bytes(mem), fits=fits,
                tc=fmt_time(roof["t_compute_s"]),
                tm=fmt_time(roof["t_memory_s"]),
                tl=fmt_time(roof["t_collective_s"]),
                dom=roof["dominant"],
                tmod=fmt_time(t_model),
                ratio=f"{ratio:.2f}" if ratio else "",
            )
        )
    return "\n".join(out)


def summary(recs):
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skip"]
    fail = [r for r in recs if r["status"] == "fail"]
    lines = [f"cells: {len(recs)}  ok: {len(ok)}  skip: {len(skip)}  "
             f"fail: {len(fail)}"]
    worst = sorted(
        (r for r in ok if r.get("useful_flop_ratio") and r["shape"] != "decode_32k"),
        key=lambda r: r["useful_flop_ratio"],
    )
    if worst:
        lines.append("worst useful-flop ratios (model/traced):")
        for r in worst[:5]:
            lines.append(
                f"  {r['arch']}.{r['shape']}.{r['mesh']}: "
                f"{r['useful_flop_ratio']:.3f}"
            )
    coll = sorted(
        ok, key=lambda r: -(r["roofline"]["t_collective_s"]
                            / max(r["roofline"]["t_compute_s"]
                                  + r["roofline"]["t_memory_s"], 1e-12)),
    )
    lines.append("most collective-bound:")
    for r in coll[:5]:
        roof = r["roofline"]
        lines.append(
            f"  {r['arch']}.{r['shape']}.{r['mesh']}: "
            f"t_coll={fmt_time(roof['t_collective_s'])} vs "
            f"t_comp={fmt_time(roof['t_compute_s'])} "
            f"t_mem={fmt_time(roof['t_memory_s'])} dom={roof['dominant']}"
        )
    over = [r for r in ok
            if r["memory"]["per_device_total"] > HBM_PER_CHIP]
    lines.append(f"cells over {HBM_PER_CHIP / 2**30:.2f}GiB/chip (traced peak, activations "
                 f"not split over the model axis): "
                 f"{[(r['arch'] + '.' + r['shape'] + '.' + r['mesh']) for r in over]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(summary(recs))
    if args.table:
        print()
        print(roofline_table(recs, args.mesh))


if __name__ == "__main__":
    main()
