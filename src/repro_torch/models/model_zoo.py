"""Model facade: a port of ``src/repro/models/model_zoo.py:21-61``.

:class:`Model` is an ``nn.Module`` that holds its parameters (the
reference's ``Model`` is a stateless facade over a parameter pytree), so
``prefill`` and ``decode_step`` take no ``params``.  ``build_model(cfg)``
runs on the card unless the caller passes ``device="cpu"``.  ``loss_fn``
(training), ``input_specs`` and the other dry-run helpers wait for ROADMAP
A16.
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
                              "ported yet: ROADMAP A16")
