"""Model facade: a port of ``src/repro/models/model_zoo.py:21-61``.

:class:`Model` is an ``nn.Module`` that holds its serving parameters (the
reference's ``Model`` is a stateless facade over a parameter pytree), so
``prefill`` and ``decode_step`` take no ``params``; they run under
``inference_mode`` on frozen float32 parameters.  Training takes the
parameters as a plain tree instead, as the reference does:
:meth:`Model.init_params` draws one (float32 tensors, ``blocks`` a list of
one dict per repeat, the draw :meth:`Model.init` makes), and
:meth:`Model.loss_fn` differentiates through whatever tree it is given.  ``build_model(cfg)`` runs on the card unless the caller passes
``device="cpu"``.  ``init_shapes``, ``input_specs`` and the other dry-run
helpers wait for ROADMAP A16.3.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.tables.table import resolve_device


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params: T.Transformer | None = None

    def init(self, generator: torch.Generator | None = None) -> "Model":
        """Draw the parameters from ``generator`` (seed 0 on the model's
        device by default), on the model's device."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        return self.load(T.init_params(generator, self.cfg, self.device))

    def init_params(self, generator: torch.Generator | None = None) -> dict:
        """A fresh parameter tree of float32 tensors on the model's device,
        drawn as :meth:`init` draws it (seed 0 by default), for training;
        the model keeps nothing."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        return T.init_params(generator, self.cfg, self.device)

    def loss_fn(self, params, batch, remat: bool = True):
        """The mean next-token CE of ``batch`` under ``params`` (a plain
        tree, e.g. the bf16 compute cast of :meth:`init_params`' float32
        masters), differentiable."""
        return T.loss_fn(params, batch, self.cfg, remat=remat)

    def init_shapes(self):
        raise NotImplementedError("init_shapes (the dry-run's parameter shapes) is "
                                  "not ported yet: ROADMAP A16.3")

    def load(self, params: dict) -> "Model":
        """Take a parameter tree as :func:`transformer.init_params` builds it."""
        self.params = T.Transformer(self.cfg, params)
        return self

    def _p(self) -> T.Transformer:
        if self.params is None:
            raise RuntimeError("the model has no parameters: call init() or load()")
        return self.params

    @torch.inference_mode()
    def prefill(self, tokens, memory=None, max_len=None):
        return T.prefill(self._p(), tokens, self.cfg, memory, max_len)

    @torch.inference_mode()
    def decode_step(self, cache, tokens):
        return T.decode_step(self._p(), cache, tokens, self.cfg)

    def init_cache(self, batch, max_len, memory_len=0):
        return T.init_cache(self.cfg, batch, max_len, memory_len, device=self.device)


def build_model(cfg: ArchConfig, device=None) -> Model:
    return Model(cfg, device)


def input_specs(*args, **kwargs):
    raise NotImplementedError("input_specs (the dry-run's stand-ins) is not "
                              "ported yet: ROADMAP A16.3")
