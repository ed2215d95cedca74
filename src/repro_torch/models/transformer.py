"""Model assembly: a port of ``src/repro/models/transformer.py`` for the
decoder, encoder and encoder-decoder stacks of attention (GQA or
multi-head latent attention), cross-attention and Mamba-2 super-blocks
with dense or mixture-of-experts MLPs, with the reference's three entry
points:

  * ``loss_fn(params, batch, cfg)``         — next-token CE (chunked)
  * ``prefill(params, tokens, cfg, ...)``   — forward + KV/SSM cache
  * ``decode_step(params, cache, t, cfg)``  — single-token serve step

The reference folds depth into ``lax.scan`` over ``n_repeats`` stacked
super-blocks; here depth is a loop over a list of super-blocks, and the
sequence form (``_layer_seq``, ``_stack_seq``, ``forward``) is functional
over either parameter tree: a plain dict ``{"embed", "final_norm",
["lm_head"], "blocks": [one dict per repeat]}`` of tensors (training: the
tensors may require grad, or be the bf16 cast of ones that do), or the
serving :class:`Transformer` module, an ``nn.ModuleList`` of
:class:`SuperBlock` modules holding frozen float32 parameters named by the
reference's dict keys (``blocks.<r>.layer<i>.attn.wq`` is
``params["blocks"]["layer<i>"]["attn"]["wq"][r]``).  An encoder-decoder
model's tree also holds ``encoder = {"blocks": [one single-layer dict per
encoder layer], "final_norm"}``, and a cross-attention layer's
parameters hold a 0-d ``gate``.  ``forward(...,
remat=True)`` rematerialises each super-block with
``torch.utils.checkpoint`` (non-reentrant) when grad is enabled, as the
reference wraps its scan body in ``jax.checkpoint``.

``shard_batch`` (``dist/activations.py``) is the identity on one card.
The decode cache is a dict ``{"pos": int, "layers": [one dict per
super-block]}``, each layer's entry ``kv``, ``latent`` (MLA) or ``ssm``,
and ``memory_kv`` for a layer that attends to the memory (the ``cross``
mixer or a ``cross_memory`` sublayer); decode updates its tensors in
place.  The memory (vision patches or audio frames, (B, M, D)) goes
through the encoder where the model has one (``encode``: the attention
stack without the causal mask), then each cross layer's k and v are
computed from it once, in prefill.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as ATT
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.layers import (COMPUTE_DTYPE, _dense_init,
                                       chunked_softmax_xent, init_mlp, init_moe,
                                       init_rmsnorm, mlp, moe, rmsnorm)


#: the encoder's super-block: one attention layer with a dense MLP, run
#: without the causal mask
ENCODER_BLOCK = (LayerSpec(mixer="attn", mlp="dense"),)


# ---------------------------------------------------------------------------
# parameters as modules
# ---------------------------------------------------------------------------


class Params(nn.Module):
    """A nested dict of tensors as a module: each leaf a (frozen)
    ``nn.Parameter`` named by its key, each nested dict a child module.
    Indexable by key like the reference's dict, so the functional layers
    take either."""

    def __init__(self, tree: dict | None = None):
        super().__init__()
        for name, value in (tree or {}).items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)


class Layer(Params):
    """One layer of a super-block: the reference's ``layer<i>`` dict, with
    its decode form (the body of ``decode_step``); its sequence form is
    :func:`_layer_seq`, shared with the training trees."""

    def __init__(self, spec: LayerSpec, cfg: ArchConfig, tree: dict):
        super().__init__(tree)
        self.spec = spec
        self.cfg = cfg

    def decode(self, h, c: dict, pos: int):
        """(h', new cache entry) for one token (B, 1, D)."""
        spec, cfg = self.spec, self.cfg
        nc = {}
        if spec.mixer == "attn":
            hh = rmsnorm(h, self["norm1"], cfg.norm_eps)
            if cfg.mla:
                o, nc["latent"] = ATT.mla_decode(self["attn"], hh, c["latent"], pos, cfg)
            else:
                o, nc["kv"] = ATT.attention_decode(self["attn"], hh, c["kv"], pos, cfg,
                                                   window=spec.window)
            h = h + o
        elif spec.mixer == "cross":
            hh = rmsnorm(h, self["norm1"], cfg.norm_eps)
            h = h + ATT.cross_attention(self["attn"], hh, c["memory_kv"], cfg)
            nc["memory_kv"] = c["memory_kv"]
        elif spec.mixer == "mamba":
            hh = rmsnorm(h, self["norm1"], cfg.norm_eps)
            o, st = SSM.mamba_decode(self["mamba"], hh, c["ssm"], cfg)
            nc["ssm"] = st
            h = h + o
        if spec.cross_memory:
            hh = rmsnorm(h, self["norm_x"], cfg.norm_eps)
            h = h + ATT.cross_attention(self["xattn"], hh, c["memory_kv"], cfg)
            nc["memory_kv"] = c["memory_kv"]
        if spec.mlp == "dense":
            h = h + mlp(self["mlp"], rmsnorm(h, self["norm2"], cfg.norm_eps))
        elif spec.mlp == "moe":
            h = h + moe(self["moe"], rmsnorm(h, self["norm2"], cfg.norm_eps), cfg.moe.top_k)
        return h, nc


class SuperBlock(nn.Module):
    """One repeat of ``cfg.super_block`` (or of ``super_block``, the
    encoder's): children ``layer0``, ``layer1``..."""

    def __init__(self, cfg: ArchConfig, tree: dict, super_block=None):
        super().__init__()
        for i, spec in enumerate(super_block or cfg.super_block):
            self.add_module(f"layer{i}", Layer(spec, cfg, tree[f"layer{i}"]))

    def __getitem__(self, name: str) -> Layer:
        return self._modules[name]


class Transformer(Params):
    """The whole parameter tree: ``embed``, ``final_norm``, ``lm_head``
    (untied models only), ``blocks``, one :class:`SuperBlock` per repeat,
    and an encoder-decoder model's ``encoder`` (``final_norm`` and
    ``blocks``, one single-layer :class:`SuperBlock` per encoder layer)."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__({k: v for k, v in params.items() if k not in ("blocks", "encoder")})
        self.cfg = cfg
        self.blocks = nn.ModuleList(SuperBlock(cfg, b) for b in params["blocks"])
        if "encoder" in params:
            enc = params["encoder"]
            self.encoder = Params({"final_norm": enc["final_norm"]})
            self.encoder.blocks = nn.ModuleList(SuperBlock(cfg, b, ENCODER_BLOCK)
                                                for b in enc["blocks"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(generator, spec: LayerSpec, cfg: ArchConfig, device):
    out = {}
    if spec.mixer == "attn":
        out["norm1"] = init_rmsnorm(cfg.d_model, device)
        out["attn"] = (ATT.init_mla(generator, cfg, device) if cfg.mla
                       else ATT.init_attention(generator, cfg, device))
    elif spec.mixer == "cross":
        out["norm1"] = init_rmsnorm(cfg.d_model, device)
        out["attn"] = ATT.init_cross_attention(generator, cfg, device)
    elif spec.mixer == "mamba":
        out["norm1"] = init_rmsnorm(cfg.d_model, device)
        out["mamba"] = SSM.init_mamba(generator, cfg, device)
    if spec.cross_memory:
        out["norm_x"] = init_rmsnorm(cfg.d_model, device)
        out["xattn"] = ATT.init_cross_attention(generator, cfg, device)
    if spec.mlp == "dense":
        out["norm2"] = init_rmsnorm(cfg.d_model, device)
        out["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, device)
    elif spec.mlp == "moe":
        out["norm2"] = init_rmsnorm(cfg.d_model, device)
        out["moe"] = init_moe(generator, cfg.d_model, cfg.moe.d_ff_expert or cfg.d_ff,
                              cfg.moe.n_experts, cfg.moe.storage_experts, device)
    return out


def init_params(generator: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """The parameter tree, drawn in order from ``generator`` on
    ``device`` (the generator's own by default): ``blocks`` is a list of
    one dict per repeat (the reference stacks them along a leading axis),
    and so are an encoder-decoder model's ``encoder["blocks"]``, one
    single-layer dict per encoder layer."""
    device = device or generator.device
    params = {
        "embed": _dense_init(generator, (cfg.vocab, cfg.d_model), scale=0.02,
                             device=device),
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(generator, (cfg.d_model, cfg.vocab),
                                        device=device)
    params["blocks"] = [
        {f"layer{i}": _init_layer(generator, spec, cfg, device)
         for i, spec in enumerate(cfg.super_block)}
        for _ in range(cfg.n_repeats)
    ]
    if cfg.n_encoder_layers:
        params["encoder"] = {
            "blocks": [{"layer0": _init_layer(generator, ENCODER_BLOCK[0], cfg, device)}
                       for _ in range(cfg.n_encoder_layers)],
            "final_norm": init_rmsnorm(cfg.d_model, device),
        }
    return params


# ---------------------------------------------------------------------------
# sequence-form stack (prefill)
# ---------------------------------------------------------------------------


def _embed(params, tokens):
    # gather, then cast: the same values as the reference's cast, then gather
    return params["embed"][tokens].to(COMPUTE_DTYPE)


def _layer_seq(lp, spec: LayerSpec, x, cfg: ArchConfig, memory, q_offset: int,
               causal: bool, *, collect_cache: bool):
    """One layer over a sequence (B, S, D): (x', cache products).  ``lp``
    is the layer's parameters, a dict or a :class:`Layer`; ``memory``
    (B, M, D) is what a cross layer attends to.  Without
    ``collect_cache`` a Mamba layer skips its final states (the cache's
    only use)."""
    cache_out = {}
    if spec.mixer == "attn":
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if cfg.mla:
            o, cache_out["latent"] = ATT.mla_seq(lp["attn"], h, cfg, q_offset=q_offset)
        else:
            o, cache_out["kv"] = ATT.attention_seq(lp["attn"], h, cfg, window=spec.window,
                                                   q_offset=q_offset, causal=causal)
        x = x + o
    elif spec.mixer == "cross":
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        cache_out["memory_kv"] = mkv = ATT.cross_memory(lp["attn"], memory, cfg)
        x = x + ATT.cross_attention(lp["attn"], h, mkv, cfg)
    elif spec.mixer == "mamba":
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        o, state = SSM.mamba_seq(lp["mamba"], h, cfg, collect_cache=collect_cache)
        if collect_cache:
            cache_out["ssm"] = state
        x = x + o
    if spec.cross_memory:
        h = rmsnorm(x, lp["norm_x"], cfg.norm_eps)
        cache_out["memory_kv"] = mkv = ATT.cross_memory(lp["xattn"], memory, cfg)
        x = x + ATT.cross_attention(lp["xattn"], h, mkv, cfg)
    if spec.mlp == "dense":
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
    elif spec.mlp == "moe":
        x = x + moe(lp["moe"], rmsnorm(x, lp["norm2"], cfg.norm_eps), cfg.moe.top_k)
    return x, cache_out


def _block_seq(bp, x, cfg: ArchConfig, memory, q_offset: int, causal: bool, super_block,
               *, collect_cache: bool):
    """One super-block (a repeat): (x', {layer<i>: cache products})."""
    caches = {}
    for i, spec in enumerate(super_block):
        x, caches[f"layer{i}"] = _layer_seq(bp[f"layer{i}"], spec, x, cfg, memory, q_offset,
                                            causal, collect_cache=collect_cache)
    return x, caches


def _stack_seq(params, x, cfg: ArchConfig, memory=None, q_offset: int = 0, *,
               collect_cache: bool = False, causal: bool = True, remat: bool = False,
               super_block=None):
    """The super-blocks of ``params["blocks"]`` in order, each
    ``super_block`` (``cfg.super_block`` by default).  With ``remat`` and
    grad enabled each is rematerialised: its activations are recomputed in
    the backward."""
    super_block = super_block or cfg.super_block
    caches = []
    for bp in params["blocks"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(lambda h, m, bp=bp: _block_seq(bp, h, cfg, m, q_offset, causal,
                                                          super_block,
                                                          collect_cache=False)[0],
                           x, memory, use_reentrant=False)
            continue
        x, c = _block_seq(bp, x, cfg, memory, q_offset, causal, super_block,
                          collect_cache=collect_cache)
        if collect_cache:
            caches.append(c)
    return x, caches


def _memory(params, memory, cfg: ArchConfig, remat: bool):
    """What the cross layers attend to: the memory through the encoder
    where the model has one, in COMPUTE_DTYPE (None stays None)."""
    if memory is None:
        return None
    if cfg.n_encoder_layers:
        memory = encode(params, memory, cfg, remat=remat)
    return memory.to(COMPUTE_DTYPE)


def forward(params, tokens, cfg: ArchConfig, memory=None, *, remat: bool = True):
    """Token ids (and the memory (B, M, D) of a model that attends to one)
    -> final hidden states (B, S, D) in COMPUTE_DTYPE."""
    memory = _memory(params, memory, cfg, remat)
    x, _ = _stack_seq(params, _embed(params, tokens), cfg, memory, remat=remat)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def encode(params, frames, cfg: ArchConfig, *, remat: bool = True):
    """The encoder stack over the frontend's embeddings (B, S_enc, D):
    attention without the causal mask, then a dense MLP, a layer each."""
    enc = params["encoder"]
    x, _ = _stack_seq(enc, frames.to(COMPUTE_DTYPE), cfg, causal=False, remat=remat,
                      super_block=ENCODER_BLOCK)
    return rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def lm_head(params, x, cfg: ArchConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ w.float()


def loss_fn(params, batch, cfg: ArchConfig, *, remat: bool = True):
    """batch: {tokens (B, S), labels (B, S)[, mask (B, S)][, memory
    (B, M, D)]} -> the mean next-token CE over the masked positions (a
    float32 0-d tensor).
    ``weight`` is ignored, as in the reference."""
    x = forward(params, batch["tokens"], cfg, batch.get("memory"), remat=remat)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return chunked_softmax_xent(x, w, batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def _cache_len(spec: LayerSpec, max_len: int) -> int:
    if spec.mixer == "attn" and spec.window is not None:
        return min(spec.window, max_len)
    return max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int, memory_len: int = 0,
               dtype=COMPUTE_DTYPE, device=None):
    """Zero-initialized decoding cache: one dict per super-block, a
    cross layer's ``memory_kv`` at ``memory_len`` memory positions."""

    def one_block():
        layers = {}
        for i, spec in enumerate(cfg.super_block):
            c = {}
            if spec.mixer == "attn" and cfg.mla:
                m = cfg.mla
                c["latent"] = torch.zeros(
                    (batch, max_len, m.kv_lora_rank + m.qk_rope_head_dim), dtype=dtype,
                    device=device)
            elif spec.mixer == "attn":
                kv_shape = (batch, cfg.n_kv_heads, _cache_len(spec, max_len),
                            cfg.head_dim)
                if cfg.kv_cache_int8:
                    # int8 codes + per-(token, head) float32 scales
                    c["kv"] = (
                        torch.zeros(kv_shape, dtype=torch.int8, device=device),
                        torch.ones(kv_shape[:-1], dtype=torch.float32, device=device),
                        torch.zeros(kv_shape, dtype=torch.int8, device=device),
                        torch.ones(kv_shape[:-1], dtype=torch.float32, device=device),
                    )
                else:
                    c["kv"] = (torch.zeros(kv_shape, dtype=dtype, device=device),
                               torch.zeros(kv_shape, dtype=dtype, device=device))
            elif spec.mixer == "mamba":
                s, d_in, H, conv_dim = SSM._dims(cfg)
                c["ssm"] = (
                    torch.zeros((batch, s.conv_kernel - 1, conv_dim), dtype=dtype,
                                device=device),
                    torch.zeros((batch, H, s.state_dim, s.head_dim),
                                dtype=torch.float32, device=device),
                )
            if spec.mixer == "cross" or spec.cross_memory:
                shape = (batch, cfg.n_kv_heads, memory_len, cfg.head_dim)
                c["memory_kv"] = (torch.zeros(shape, dtype=dtype, device=device),
                                  torch.zeros(shape, dtype=dtype, device=device))
            layers[f"layer{i}"] = c
        return layers

    return {"pos": 0, "layers": [one_block() for _ in range(cfg.n_repeats)]}


def _place(buf, arr, S: int, window):
    """The last ``min(S, L)`` positions of ``arr`` into the front of the
    cache buffer ``buf`` (sequence on dim 2), ring-aligned for windowed
    layers: the key for absolute position p sits at p % L."""
    L = buf.shape[2]
    take = min(S, L)
    buf[:, :, :take] = arr[:, :, S - take:S].to(buf.dtype)
    if window is not None:
        buf = torch.roll(buf, (S - take) % L, dims=2)
    return buf


def prefill(params, tokens, cfg: ArchConfig, memory=None, max_len=None):
    """Forward over the prompt (and the memory (B, M, D) of a model that
    attends to one); returns (last-token logits (B, V), cache)."""
    B, S = tokens.shape
    max_len = max_len or cfg.max_seq_len
    memory = _memory(params, memory, cfg, remat=False)
    x, caches = _stack_seq(params, _embed(params, tokens), cfg, memory, collect_cache=True)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head(params, x[:, -1:], cfg)[:, 0]

    # assemble the fixed-size decode cache from the prefill products (a
    # cross layer's memory_kv is the prefill's own k and v, not a copy)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    cache["pos"] = S
    for src_block, dst_block in zip(caches, cache["layers"]):
        for i, spec in enumerate(cfg.super_block):
            src, dst = src_block[f"layer{i}"], dst_block[f"layer{i}"]
            if "kv" in dst:
                k, v = src["kv"]
                if cfg.kv_cache_int8:
                    (kq, ks), (vq, vs) = ATT.quantize_kv(k), ATT.quantize_kv(v)
                    parts = (kq, ks, vq, vs)
                else:
                    parts = (k, v)
                dst["kv"] = tuple(_place(buf, arr, S, spec.window)
                                  for buf, arr in zip(dst["kv"], parts))
            if "latent" in dst:
                # the prompt's latent at positions 0..S-1 (sequence on dim 1)
                dst["latent"][:, :S] = src["latent"]
            if "ssm" in dst:
                conv, ssd = src["ssm"]
                dst["ssm"] = (conv.to(dst["ssm"][0].dtype), ssd)
            if "memory_kv" in dst:
                dst["memory_kv"] = src["memory_kv"]
    return logits, cache


def decode_step(params, cache, tokens, cfg: ArchConfig):
    """One serve step: tokens (B, 1) + cache -> (logits (B, V), cache')."""
    pos = cache["pos"]
    h = _embed(params, tokens)
    new_layers = []
    for block, lc in zip(params.blocks, cache["layers"]):
        new_lc = {}
        for i in range(len(cfg.super_block)):
            name = f"layer{i}"
            h, new_lc[name] = block[name].decode(h, lc[name], pos)
        new_layers.append(new_lc)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = lm_head(params, h, cfg)[:, 0]
    return logits, {"pos": pos + 1, "layers": new_layers}
