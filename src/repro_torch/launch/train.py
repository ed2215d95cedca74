"""Training launcher: a port of ``src/repro/launch/train.py``, on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite3_2b \
        --smoke --steps 20 --ckpt /tmp/ckpt [--device cpu]

Fault tolerance: every run resumes from the newest verifiable checkpoint
in ``--ckpt`` (a second run over the same directory continues where the
first stopped); straggler stats print at the end (feed the eviction set to
an elastic restart, see ``repro_torch.train.elastic``).  Training over
several cards is ROADMAP A16.3.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import config_for, smoke_config_for
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.straggler import StragglerTracker
from repro_torch.train.train_loop import TrainState, init_state, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite3_2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config_for(args.arch) if args.smoke else config_for(args.arch)
    model = build_model(cfg, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                          total_steps=args.steps)

    mgr = None
    state = None
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt, keep_n=3)
        step, restored = mgr.restore_latest(model.device)
        if restored is not None:
            print(f"resuming from checkpoint step {step}")
            state = TrainState(restored["params"], restored["opt"], None)
    if state is None:
        state = init_state(model, torch.Generator(model.device).manual_seed(args.seed),
                           opt_cfg, compress=args.compress)

    pipe = DataPipeline(batch=args.batch, seq_len=args.seq, vocab=cfg.vocab,
                        seed=args.seed, device=model.device)
    straggler = StragglerTracker()
    state = train_loop(
        model, state, iter(pipe), opt_cfg, steps=args.steps,
        checkpoint_mgr=mgr, checkpoint_every=args.checkpoint_every,
        straggler=straggler, microbatches=args.microbatches,
        compress=args.compress,
    )
    if mgr is not None:
        # the reference saves the last step again even where the loop just
        # did (a multiple of --checkpoint-every), and that second rename
        # fails (ROADMAP C8): save it only where the loop did not
        mgr.wait()
        if mgr.latest_step() != args.steps:
            mgr.save(args.steps, {"params": state.params, "opt": state.opt})
            mgr.wait()
    if straggler.should_evict():
        print(f"straggler eviction candidates: {straggler.should_evict()}")
    print(f"done at step {int(state.opt['step'])}")
    return state


if __name__ == "__main__":
    main()
