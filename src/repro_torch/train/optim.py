"""AdamW: a port of ``src/repro/train/optim.py``, with low-precision
moments (bf16 by default; ``.to(torch.bfloat16)`` rounds to nearest even,
as ``astype`` does), global-norm clipping, and a linear-warmup +
cosine-decay schedule.  Pure functions over the port's parameter trees
(nested dicts and lists of tensors, :mod:`repro_torch.tree`); arithmetic
is float32 and ``step`` an int32 0-d tensor, on the parameters' device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "bfloat16"  # f32 master params; bf16 m/v
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or a 0-d tensor), a float32
    0-d tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step: (new params, new optimizer state, {"grad_norm",
    "lr"}), each a new tree (nothing updated in place)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm),
                          _f32(cfg.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-12))

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, m, v):
        g = g.float() * scale
        mf = m.float() * b1 + (1 - b1) * g
        vf = v.float() * b2 + (1 - b2) * g * g
        mh = mf / bc1
        vh = vf / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        new_p = p.float() * (1 - lr * cfg.weight_decay) - lr * delta
        return new_p.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    flat_p = tree_leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
