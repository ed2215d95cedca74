"""Training step + loop: a port of ``src/repro/train/train_loop.py`` —
microbatch gradient accumulation, optional int8 error-feedback gradient
compression, straggler tracking, and fault-tolerant checkpoint/resume.

The reference jits its step with the state donated; PyTorch runs eagerly,
and eager is the port's counterpart (as in serving): ``train_loop``'s
``jit`` argument is accepted and ignored.  Where the reference calls
``block_until_ready``, the loop synchronises the device of the loss.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.dist.compress import compress_tree, decompress_tree, init_error_tree
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    ef_error: Any = None  # error-feedback buffers (compression on)


def compute_params(params):
    """Mixed precision: the float32 master weights with ``ndim >= 2`` cast
    to bf16 once per step (the reference's ``loss_fn`` in
    ``make_train_step``); gradients flow back in float32 through the
    cast."""
    return tree_map(
        lambda p: p.to(COMPUTE_DTYPE) if p.dtype == torch.float32 and p.dim() >= 2 else p,
        params)


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1,
                    compress: bool = False, remat: bool = True):
    """Returns step(state, batch) -> (state, metrics).

    ``microbatches`` > 1 splits the per-step batch on the leading axis and
    sums the microbatches' gradients (each backward accumulates into the
    float32 masters' ``.grad``), then scales them by ``1/microbatches`` in
    place, as the reference's scan does (out of place).  The optimizer's
    update is a new tree (:func:`~repro_torch.train.optim.adamw_update`):
    while it runs, the old and new parameters and moments are both held.
    The state passed in is left as it was.  ``compress`` applies int8 error-feedback
    quantization to the grads before the optimizer (the wire format of the
    cross-pod reduction).  ``remat`` rematerialises each super-block."""

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        masters = tree_unflatten(params, leaves)
        n = batch["tokens"].shape[0] // microbatches
        loss = None
        for i in range(microbatches):
            one = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l = model.loss_fn(compute_params(masters), one, remat=remat)
            l.backward()
            loss = l.detach() if loss is None else loss + l.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        if microbatches > 1:
            inv = 1.0 / microbatches
            loss = loss * inv
            for g in grads:  # in place: the accumulated buffers are this step's own
                g.mul_(inv)
        return loss, tree_unflatten(params, grads)

    def step(state: TrainState, batch):
        loss, grads = grads_of(state.params, batch)
        ef = state.ef_error
        if compress:
            payload, ef = compress_tree(grads, ef)
            grads = decompress_tree(payload)
        params, opt, metrics = adamw_update(state.params, grads, state.opt, opt_cfg)
        metrics["loss"] = loss
        return TrainState(params, opt, ef), metrics

    return step


def init_state(model, generator: torch.Generator | None, opt_cfg: AdamWConfig,
               compress: bool = False) -> TrainState:
    """Fresh float32 parameters drawn from ``generator`` (seed 0 on the
    model's device by default), zero moments and step."""
    params = model.init_params(generator)
    opt = adamw_init(params, opt_cfg)
    ef = init_error_tree(params) if compress else None
    return TrainState(params, opt, ef)


def train_loop(
    model,
    state: TrainState,
    batches,
    opt_cfg: AdamWConfig,
    *,
    steps: int,
    checkpoint_mgr=None,
    checkpoint_every: int = 50,
    straggler=None,
    log_every: int = 10,
    microbatches: int = 1,
    compress: bool = False,
    jit: bool = True,
    log: Callable[[str], None] = print,
    history: list | None = None,
):
    """Drives ``steps`` optimizer steps; checkpoints / resumes; tracks
    per-step wall time for straggler mitigation.  ``jit`` is ignored (the
    step runs eagerly).  With ``history`` a list, each step appends
    ``{"step", "loss", "grad_norm", "lr", "seconds"}`` to it.

    ``state`` is consumed, as the reference donates it to its jitted step:
    after each step its fields are rebound to the new trees, so a caller
    still holding it keeps no earlier step's parameters and moments alive
    (a step holds two states, the old and the new, and no more).  The
    returned state is that object."""
    step_fn = make_train_step(model, opt_cfg, microbatches, compress)

    start = int(state.opt["step"])
    it = iter(batches)
    for i in range(start, steps):
        batch = next(it)
        t0 = time.perf_counter()
        new, metrics = step_fn(state, batch)
        state.params, state.opt, state.ef_error = new.params, new.opt, new.ef_error
        del new
        if metrics["loss"].is_cuda:
            torch.cuda.synchronize(metrics["loss"].device)
        dt = time.perf_counter() - t0
        if straggler is not None:
            straggler.record(host=0, step=i, seconds=dt)
        if history is not None:
            history.append({"step": i + 1, "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]), "seconds": dt})
        if log_every and (i + 1) % log_every == 0:
            log(
                f"step {i+1}: loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
            )
        if checkpoint_mgr is not None and (i + 1) % checkpoint_every == 0:
            checkpoint_mgr.save(i + 1, {"params": state.params, "opt": state.opt})
    return state
