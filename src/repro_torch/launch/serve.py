"""Serving launcher: a port of ``src/repro/launch/serve.py`` — batched
requests through the slot engine with Froid-compiled admission rules, on
the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite3_2b \
        --smoke --requests 8 --max-new 16 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import config_for, smoke_config_for
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite3_2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--admission", default="froid",
                    choices=["froid", "interpreted", "hekaton"],
                    help="ExecutionPolicy preset for the admission rules")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config_for(args.arch) if args.smoke else config_for(args.arch)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(model.device).manual_seed(args.seed))
    eng = ServeEngine(model, slots=args.slots, max_len=args.max_len,
                      admission_policy=args.admission, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, rng.integers(4, 16)).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=float(rng.choice([0.0, 0.7, 1.0])),
            tier=int(rng.integers(0, 3)),
        )
        for i in range(args.requests)
    ]
    done = eng.run(reqs)
    for c in sorted(done, key=lambda c: c.rid):
        print(f"req {c.rid}: {len(c.tokens)} tokens ({c.reason}) {c.tokens[:8]}…")
    return done


if __name__ == "__main__":
    main()
