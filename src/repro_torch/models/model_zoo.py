"""Model facade and the input specs of every (arch x shape) cell: a port
of ``src/repro/models/model_zoo.py``.

:class:`Model` is an ``nn.Module`` that holds its serving parameters (the
reference's ``Model`` is a stateless facade over a parameter pytree), so
``prefill`` and ``decode_step`` take no ``params``; they run under
``inference_mode`` on frozen parameters.  Training takes the parameters as
a plain tree instead, as the reference does: :meth:`Model.init_params`
draws one (float32 tensors, ``blocks`` a list of one dict per repeat, the
draw :meth:`Model.init` makes), and :meth:`Model.loss_fn`,
:meth:`Model.forward` and :meth:`Model.lm_head` take whatever tree they
are given.  ``build_model(cfg)`` runs on the card unless the caller passes
``device="cpu"``.

Where the reference takes ``jax.ShapeDtypeStruct`` stand-ins, the port
takes ``meta`` tensors, drawn by the port's own ``init_params`` and
``init_cache`` (from a CPU generator), so no second description of the
trees exists to drift from the real ones: :meth:`Model.init_shapes`,
:meth:`Model.cache_shapes` and :func:`input_specs` (the dry run's inputs,
``launch/dryrun.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.tables.table import resolve_device

AUDIO_DECODE_MEMORY = 1536  # stub frame count for enc-dec decode shapes
META = torch.device("meta")


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

    def init_shapes(self) -> dict:
        """The parameter tree as ``meta`` tensors (float32, no memory),
        drawn by :func:`transformer.init_params` itself."""
        return T.init_params(torch.Generator("cpu"), self.cfg, META)

    def forward(self, params, tokens, memory=None, remat: bool = True):
        """Final hidden states (B, S, D) of ``tokens`` under ``params``."""
        return T.forward(params, tokens, self.cfg, memory, remat=remat)

    def lm_head(self, params, x):
        return T.lm_head(params, x, self.cfg)

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

    def cache_shapes(self, batch, max_len, memory_len=0) -> dict:
        """The decode cache as ``meta`` tensors (``pos`` an int), as
        :func:`transformer.init_cache` lays it out."""
        return T.init_cache(self.cfg, batch, max_len, memory_len, device=META)


def build_model(cfg: ArchConfig, device=None) -> Model:
    return Model(cfg, device)


# ---------------------------------------------------------------------------
# input specs per (arch x shape)
# ---------------------------------------------------------------------------


def _memory_spec(cfg: ArchConfig, batch: int, seq_len: int):
    if cfg.vision_tokens:
        return torch.empty((batch, cfg.vision_tokens, cfg.d_model), dtype=COMPUTE_DTYPE,
                           device=META)
    if cfg.n_encoder_layers:
        return torch.empty((batch, seq_len, cfg.d_model), dtype=COMPUTE_DTYPE, device=META)
    return None


def memory_len_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    if cfg.vision_tokens:
        return cfg.vision_tokens
    if cfg.n_encoder_layers:
        return shape.seq_len if shape.kind != "decode" else AUDIO_DECODE_MEMORY
    return 0


def shape_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: long_500k skipped (DESIGN.md §5)"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeConfig | str) -> dict:
    """``meta`` stand-ins for every model input of this cell: int32 tokens
    (and labels), the memory of a model that attends to one, a decode
    step's cache."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    tok = torch.empty((B, S), dtype=torch.int32, device=META)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": tok}
        if shape.kind == "train":
            specs["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
        mem = _memory_spec(cfg, B, S)
        if mem is not None:
            specs["memory"] = mem
        return specs
    if shape.kind == "decode":
        cache = build_model(cfg, META).cache_shapes(B, S, memory_len_for(cfg, shape))
        return {"tokens": torch.empty((B, 1), dtype=torch.int32, device=META), "cache": cache}
    raise ValueError(shape.kind)
