"""The port's model zoo (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU, with the reference's parameters carried
across by ``params_from_reference`` and inputs made with numpy from a
seed.

Tolerances:
* float32 inputs to the layers: 1e-5 (the same float32 arithmetic, summed
  in another order);
* bf16 activations (the models' compute dtype): 2e-2 x max|output| — JAX
  and torch both sum bf16 products in float32 but round at other places;
* the stack in float32 compute (``COMPUTE_DTYPE`` patched in both
  packages): 1e-4 x max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as RT
import repro_torch.models.transformer as TT
from repro.configs import ARCH_IDS, config_for, smoke_config_for
from repro.models import attention as RA
from repro.models import build_model as ref_build
from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.config import LayerSpec
from repro_torch.models.convert import params_from_reference


def _t(x, dtype=None):
    out = torch.as_tensor(np.array(np.asarray(x, np.float32)))
    return out.to(dtype) if dtype is not None else out


def _tree(params):
    return jax.tree.map(lambda a: _t(a), params)


def _err(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max()) / (float(np.abs(j).max()) + 1e-9)


def _variant(name: str, which: str):
    """A smoke config, plain, with a sliding window or an int8 KV cache
    (granite), or at the arch's published head dim (``"head_dim"``: phi3's
    96 with MHA; gemma3's 256 with local/local/global layers, a 16-token
    window and tied embeddings), or with the published MLA dims
    (``"mla"``: minicpm3-4b's ranks 768 and 256, qk 64 + 32, v 64, so that
    v is padded to 96), in the reference's and the port's dataclasses."""
    ref, port = smoke_config_for(name), tconfigs.smoke_config_for(name)
    if which == "mla":
        full = config_for(name)
        ref = dataclasses.replace(ref, mla=full.mla, head_dim=full.head_dim)
        port = dataclasses.replace(port, mla=tconfigs.config_for(name).mla,
                                   head_dim=full.head_dim)
    elif which == "head_dim":
        hd = config_for(name).head_dim
        ref, port = dataclasses.replace(ref, head_dim=hd), dataclasses.replace(port, head_dim=hd)
    elif which == "window":
        ref = dataclasses.replace(ref, super_block=(type(ref.super_block[0])(window=8),
                                                    type(ref.super_block[0])()))
        port = dataclasses.replace(port, super_block=(LayerSpec(window=8), LayerSpec()))
    elif which == "int8":
        ref = dataclasses.replace(ref, kv_cache_int8=True)
        port = dataclasses.replace(port, kv_cache_int8=True)
    return ref, port


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copies_equal_the_reference(arch):
    assert dataclasses.asdict(tconfigs.config_for(arch)) == dataclasses.asdict(config_for(arch))
    assert dataclasses.asdict(tconfigs.smoke_config_for(arch)) == \
        dataclasses.asdict(smoke_config_for(arch))
    assert tconfigs.config_for(arch).param_count() == config_for(arch).param_count()


def test_rmsnorm_rope_mlp(rng):
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32) * 0.1
    assert _err(TL.rmsnorm(_t(x), _t(w)), RL.rmsnorm(jnp.asarray(x), jnp.asarray(w))) < 1e-5
    pos = np.arange(5)[None, :] + 3
    assert _err(TL.apply_rope(_t(x), torch.as_tensor(pos)),
                RL.apply_rope(jnp.asarray(x), jnp.asarray(pos))) < 1e-5
    p = RL.init_mlp(jax.random.PRNGKey(0), 32, 64)
    assert _err(TL.mlp(_tree(p), _t(x)), RL.mlp(p, jnp.asarray(x))) < 1e-5
    xb = jnp.asarray(x, jnp.bfloat16)
    assert _err(TL.mlp(_tree(p), _t(x, torch.bfloat16)), RL.mlp(p, xb)) < 2e-2
    assert _err(TL.rmsnorm(_t(x, torch.bfloat16), _t(w)), RL.rmsnorm(xb, jnp.asarray(w))) < 2e-2


@pytest.mark.parametrize("which", ["plain", "window", "int8"])
def test_attention_seq_and_decode(rng, which):
    ref_cfg, cfg = _variant("granite3_2b", which)
    window = ref_cfg.super_block[0].window
    p = RA.init_attention(jax.random.PRNGKey(1), ref_cfg)
    tp = _tree(p)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    o_ref, (k_ref, v_ref) = RA.attention_seq(p, jnp.asarray(x), ref_cfg, window=window)
    o, (k, v) = TA.attention_seq(tp, _t(x), cfg, window=window)
    assert _err(o, o_ref) < 1e-5 and _err(k, k_ref) < 1e-5 and _err(v, v_ref) < 1e-5
    # decode at positions 12.. into a cache of 16 slots (a ring of 8 when windowed)
    L = window or 16
    shape = (2, cfg.n_kv_heads, L, cfg.head_dim)
    if which == "int8":
        jc = (jnp.zeros(shape, jnp.int8), jnp.ones(shape[:-1]), jnp.zeros(shape, jnp.int8),
              jnp.ones(shape[:-1]))
        tc = (torch.zeros(shape, dtype=torch.int8), torch.ones(shape[:-1]),
              torch.zeros(shape, dtype=torch.int8), torch.ones(shape[:-1]))
    else:
        jc = (jnp.zeros(shape), jnp.zeros(shape))
        tc = (torch.zeros(shape), torch.zeros(shape))
    for pos in range(12, 22 if window else 16):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        o_ref, jc = RA.attention_decode(p, jnp.asarray(xt), jc, pos, ref_cfg, window=window)
        o, tc = TA.attention_decode(tp, _t(xt), tc, pos, cfg, window=window)
        assert _err(o, o_ref) < 1e-5, pos
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       atol=1e-5, rtol=1e-5)


def test_quantize_kv_rounds_half_to_even():
    x = np.array([[0.5, 1.5, 2.5, -0.5, 127.0, -3.5]], np.float32)
    q, s = TA.quantize_kv(_t(x))
    jq, js = RA.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_mamba_seq_and_decode(rng):
    ref_cfg, cfg = smoke_config_for("mamba2_370m"), tconfigs.smoke_config_for("mamba2_370m")
    p = RS.init_mamba(jax.random.PRNGKey(2), ref_cfg)
    p["dt_bias"] = jnp.asarray(rng.normal(size=p["dt_bias"].shape) * 0.5, jnp.float32)
    tp = _tree(p)
    x = rng.normal(size=(2, 70, cfg.d_model)).astype(np.float32)  # > 64: the chunked form
    o_ref, (conv_ref, ssd_ref) = RS.mamba_seq(p, jnp.asarray(x), ref_cfg)
    o, (conv, ssd) = TS.mamba_seq(tp, _t(x), cfg)
    assert _err(o, o_ref) < 1e-5
    assert _err(conv, conv_ref) < 1e-5 and _err(ssd, ssd_ref) < 1e-5
    jstate, tstate = (conv_ref, ssd_ref), (conv, ssd)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        o_ref, jstate = RS.mamba_decode(p, jnp.asarray(xt), jstate, ref_cfg)
        o, tstate = TS.mamba_decode(tp, _t(xt), tstate, cfg)
        assert _err(o, o_ref) < 1e-5
        assert _err(tstate[1], jstate[1]) < 1e-5


#: the value every cross-attention gate is set to in both packages: a
#: fresh gate is 0, and tanh(0) = 0 hides cross-attention from a parity test
GATE = 1.0


def _gated(tree, value=GATE):
    """``tree`` (the reference's dicts of arrays) with every ``gate`` leaf
    set to ``value``."""
    return {k: _gated(v, value) if isinstance(v, dict)
            else (jnp.full_like(v, value) if k == "gate" else v) for k, v in tree.items()}


def _carried(ref_cfg, cfg, seed=0):
    model = ref_build(ref_cfg)
    params = _gated(model.init(jax.random.PRNGKey(seed)))
    port = params_from_reference(jax.tree.map(np.asarray, params), cfg, "cpu")
    return model, params, port


def _memory(cfg, rng, S, batch=2):
    """A model's memory input (B, M, D) as float32 numpy, unit scale:
    vision patches (M = ``cfg.vision_tokens``) or audio frames as long as
    the prompt (the reference's ``_memory_spec``); None for a decoder."""
    M = cfg.vision_tokens or (S if cfg.n_encoder_layers else 0)
    return rng.normal(size=(batch, M, cfg.d_model)).astype(np.float32) if M else None


def _mem_args(memory, dtype):
    """The memory as each package takes it, in ``dtype`` (the compute
    dtype): (jax array or None, tensor or None)."""
    if memory is None:
        return None, None
    return (jnp.asarray(memory, dtype),
            torch.as_tensor(memory).to(torch.float32 if dtype == jnp.float32 else torch.bfloat16))


def _prefill_then_decode(ref_cfg, cfg, rng, tol, steps=4, dtype=jnp.bfloat16):
    """Prefill a 20-token prompt (with a memory where the model attends to
    one, in ``dtype``), then ``steps`` decode steps, in both packages: each
    step's logits within ``tol`` x the prefill's max|logit|.  A model with
    a memory is run again with the memory redrawn, as a control that must
    read outside the limit."""
    model, params, port = _carried(ref_cfg, cfg)
    toks = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    memory = _memory(cfg, rng, 20)
    jm, tm = _mem_args(memory, dtype)
    jl, jc = model.prefill(params, jnp.asarray(toks), jm, max_len=32)
    tl, tc = port.prefill(torch.as_tensor(toks), tm, max_len=32)
    scale = float(np.abs(np.asarray(jl)).max())
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= tol * scale
    assert tc["pos"] == 20 == int(jc["pos"])
    if memory is not None:
        _, other = _mem_args(_memory(cfg, np.random.default_rng(99), 20), dtype)
        ol, _ = port.prefill(torch.as_tensor(toks), other, max_len=32)
        assert float(np.abs(ol.numpy() - np.asarray(jl)).max()) > tol * scale
    for _ in range(steps):
        nt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = model.decode_step(params, jc, jnp.asarray(nt))
        tl, tc = port.decode_step(tc, torch.as_tensor(nt))
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= tol * scale


#: archs whose parity runs at the published head dim (the flash instances
#: at D = 96 and 256 that only they take on the card)
PUBLISHED_HEAD_DIM = ("phi3_mini_38b", "gemma3_12b")
#: the mixture-of-experts archs' smoke configs: granite-moe (8 experts, top
#: 4), mixtral (4, top 2, a 16-token window) and jamba's hybrid stack (Mamba
#: and attention layers, MoE on alternate ones)
MOE_ARCHS = ("granite_moe_3b_a800m", "mixtral_8x7b", "jamba15_large_398b")
#: the archs that attend to a memory: llama-3.2-vision (a cross-attention
#: layer every fifth, over vision patches) and seamless (an encoder, and a
#: cross-attention sublayer in every decoder layer)
CROSS_ARCHS = ("llama32_vision_90b", "seamless_m4t_large_v2")


@pytest.mark.parametrize("arch,which", [("granite3_2b", "plain"), ("granite3_2b", "window"),
                                        ("granite3_2b", "int8"), ("mamba2_370m", "plain"),
                                        ("phi3_mini_38b", "head_dim"),
                                        ("gemma3_12b", "head_dim"),
                                        ("granite_moe_3b_a800m", "plain"),
                                        ("minicpm3_4b", "plain"), ("minicpm3_4b", "mla"),
                                        ("mixtral_8x7b", "plain"),
                                        ("jamba15_large_398b", "eager"),
                                        ("llama32_vision_90b", "eager"),
                                        ("seamless_m4t_large_v2", "eager")])
def test_prefill_and_decode_match_reference(rng, arch, which):
    """bf16 activations, as served: within 2e-2 x max|logit|.  The 20-token
    prompt is longer than gemma3's and mixtral's 16-token windows, so their
    decode runs the ring buffer.

    ``"eager"``: the reference runs un-jitted (``jax.disable_jit``), the
    arithmetic the port follows.  Under ``jit`` XLA rounds bf16 at other
    places, and a token whose k-th and (k + 1)-th router weights lie within
    that rounding takes another expert: on jamba's smoke input 3 of the
    last MoE layer's 40 routes move, and its jitted logits lie 3.9e-2 x
    max|logit| from its own un-jitted ones.  The port is within 6e-3 of
    the un-jitted reference there (granite-moe's and mixtral's bf16 logits
    equal the un-jitted reference's bits); the float32 test below holds all
    three against the jitted reference at 1e-4.  The cross-attention archs
    (gates at :data:`GATE`, a unit-scale memory) also against the
    un-jitted reference: under ``jit`` the bf16 stack over a memory rounds
    elsewhere, and over seeds 0-2 their logits lie 0.7e-2 to 2.3e-2 x
    max|logit| from the jitted reference's and 0 to 1.4e-2 from the
    un-jitted one's (mostly bit-equal); the float32 test holds them to the
    jitted reference at 1e-4."""
    ref_cfg, cfg = _variant(arch, "plain" if which == "eager" else which)
    if which == "eager":
        with jax.disable_jit():
            _prefill_then_decode(ref_cfg, cfg, rng, 2e-2)
    else:
        _prefill_then_decode(ref_cfg, cfg, rng, 2e-2)


@pytest.mark.parametrize("arch", ["granite3_2b", "mamba2_370m", *PUBLISHED_HEAD_DIM,
                                  *MOE_ARCHS, "minicpm3_4b", "minicpm3_4b+mla",
                                  *CROSS_ARCHS, "llama32_vision_90b+head_dim"])
def test_prefill_and_decode_match_reference_float32(rng, monkeypatch, arch):
    """The same stack with float32 activations and caches in both packages:
    within 1e-4 x max|logit|, so the bf16 test's slack is rounding only
    (phi3 and gemma3 at their published head dims; the MoE archs route
    each token to the same experts in both; ``+mla``: minicpm3-4b at the
    published MLA dims; the cross-attention archs with their gates set
    and a memory, which a redrawn memory must move outside the limit, and
    llama-3.2-vision again at its published head dim 128)."""
    monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TT, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(RT.init_cache, "__defaults__", (0, jnp.float32))
    monkeypatch.setattr(TT.init_cache, "__defaults__", (0, torch.float32, None))
    arch, _, which = arch.partition("+")
    which = which or ("head_dim" if arch in PUBLISHED_HEAD_DIM else "plain")
    ref_cfg, cfg = _variant(arch, which)
    _prefill_then_decode(ref_cfg, cfg, rng, 1e-4, dtype=jnp.float32)
    model, params, port = _carried(ref_cfg, cfg, seed=1)
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jm, tm = _mem_args(_memory(cfg, rng, 9), jnp.float32)
    assert _err(TT.forward(port.params, torch.as_tensor(toks), cfg, tm),
                RT.forward(params, jnp.asarray(toks), ref_cfg, jm)) < 1e-4


@pytest.mark.parametrize("arch", ["granite3_2b", "mamba2_370m", "minicpm3_4b", *CROSS_ARCHS])
def test_decode_continues_prefill(rng, arch):
    """The port's own check: prefill over S tokens then one decode step
    gives the logits of a prefill over S + 1 tokens (over one memory, the
    gates set to :data:`GATE`; seamless's frames stay 16 long)."""
    cfg = tconfigs.smoke_config_for(arch)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(3))
    for name, p in model.named_parameters():
        if name.endswith(".gate"):
            p.data.fill_(GATE)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32))
    memory = _memory(cfg, rng, 16)
    memory = None if memory is None else torch.as_tensor(memory).bfloat16()
    _, cache = model.prefill(toks[:, :16], memory, max_len=32)
    stepped, _ = model.decode_step(cache, toks[:, 16:])
    whole, _ = model.prefill(toks, memory, max_len=32)
    assert float((stepped - whole).abs().max()) <= 2e-2 * float(whole.abs().max())


def test_parameter_names_follow_the_reference():
    cfg = tconfigs.smoke_config_for("granite3_2b")
    model = build_model(cfg, "cpu").init()
    names = {n for n, _ in model.named_parameters()}
    assert {"params.embed", "params.final_norm", "params.blocks.1.layer0.attn.wq",
            "params.blocks.0.layer0.mlp.w_down", "params.blocks.0.layer0.norm2"} <= names
    assert not any(p.requires_grad for p in model.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # MoE leaves, pad experts included (granite-moe's smoke config stored
    # padded to 12 experts, as its full config pads 40 to 48): the port's
    # own draw and the reference's carried across have the reference's
    # names and shapes, and the carried values are the reference's
    ref_cfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, pad_experts_to=12))
                    for c in (smoke_config_for("granite_moe_3b_a800m"),
                              tconfigs.smoke_config_for("granite_moe_3b_a800m")))
    ref = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    want = {f"params.blocks.{r}.layer0.moe.{leaf}": np.asarray(w[r])
            for leaf, w in ref["blocks"]["layer0"]["moe"].items()
            for r in range(cfg.n_repeats)}
    assert want["params.blocks.1.layer0.moe.w_up"].shape == (12, cfg.d_model, 64)
    assert want["params.blocks.0.layer0.moe.router"].shape == (cfg.d_model, 8)
    for model in (build_model(cfg, "cpu").init(),
                  params_from_reference(jax.tree.map(np.asarray, ref), cfg, "cpu")):
        got = {n: p for n, p in model.named_parameters() if ".moe." in n}
        assert set(got) == set(want)
        for name, value in want.items():
            assert tuple(got[name].shape) == value.shape, name
            if name.rsplit(".", 1)[1] != "router":
                assert bool((got[name][8:] == 0).all()), name
    np.testing.assert_array_equal(got["params.blocks.1.layer0.moe.w_down"].numpy(),
                                  want["params.blocks.1.layer0.moe.w_down"])


@pytest.mark.parametrize("arch,item", [("llama32_vision_90b", "A16.3"),
                                       ("seamless_m4t_large_v2", "A16.3")])
def test_unported_families_raise(arch, item):
    """Every family builds; what still raises is the dry run's helpers."""
    from repro_torch.models import model_zoo

    model = build_model(tconfigs.smoke_config_for(arch), "cpu").init()
    with pytest.raises(NotImplementedError, match=item):
        model.init_shapes()
    with pytest.raises(NotImplementedError, match=item):
        model_zoo.input_specs(model.cfg, "decode_32k")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tconfigs.smoke_config_for("granite3_2b"))
