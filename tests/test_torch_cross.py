"""Cross-attention and the encoder stack (``repro_torch.models.attention``'s
``init_cross_attention``, ``cross_memory``, ``cross_attention``;
``repro_torch.models.transformer``'s ``encode`` and the memory caches)
against the reference's on the CPU, inputs made with numpy from a seed.

Every gate is set to the same non-zero value in both packages: a fresh
gate is 0, and ``tanh(0) * out`` adds exactly nothing, so a parity test on
fresh weights would pass whatever the port computed.  Tolerances: float32
1e-5 x max|output| (the same arithmetic summed in another order), bf16
2e-2 (both sum bf16 products in float32 but round at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as RT
import repro_torch.models.transformer as TT
from repro.configs import smoke_config_for
from repro.models import attention as RA
from repro.models import build_model as ref_build
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_reference, tree_to_reference
from repro_torch.tree import stack_blocks, unstack_blocks

#: a gate's value in both packages (tanh(0.7) = 0.60)
GATE = 0.7
#: llama-3.2-vision's smoke config is GQA (4 query heads on 2 KV heads),
#: seamless's MHA (4 on 4)
LAYOUTS = ("llama32_vision_90b", "seamless_m4t_large_v2")
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(np.asarray(x, np.float32))).to(dtype)


def _err(t, j) -> float:
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max()) / (float(np.abs(j).max()) + 1e-9)


def _params(arch, seed=1):
    """The reference's cross-attention parameters for ``arch``'s smoke
    config, gate at :data:`GATE`, and the same as tensors."""
    cfg = smoke_config_for(arch)
    p = RA.init_cross_attention(jax.random.PRNGKey(seed), cfg)
    p["gate"] = jnp.asarray(GATE, jnp.float32)
    return cfg, tconfigs.smoke_config_for(arch), p, {k: _t(v) for k, v in p.items()}


def test_init_cross_attention_names_and_shapes():
    for arch in LAYOUTS:
        ref_cfg, cfg = smoke_config_for(arch), tconfigs.smoke_config_for(arch)
        ref = RA.init_cross_attention(jax.random.PRNGKey(0), ref_cfg)
        port = TA.init_cross_attention(torch.Generator().manual_seed(0), cfg)
        assert list(port) == list(ref)
        for name, value in ref.items():
            assert tuple(port[name].shape) == value.shape, (arch, name)
            assert port[name].dtype == torch.float32
        assert port["gate"].dim() == 0 and float(port["gate"]) == 0.0 == float(ref["gate"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,M", [(12, 70), (520, 600)])
@pytest.mark.parametrize("arch", LAYOUTS)
def test_cross_memory_and_attention(rng, arch, S, M, dtype):
    """Sq != M, M not a multiple of 64; (520, 600) is above the plain
    version's dense threshold (512 x 512 scores), so both packages take
    their chunked online-softmax form."""
    jdt, tdt, tol = DTYPES[dtype]
    ref_cfg, cfg, p, tp = _params(arch)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    memory = rng.normal(size=(2, M, cfg.d_model)).astype(np.float32)
    jk, jv = RA.cross_memory(p, jnp.asarray(memory, jdt), ref_cfg)
    k, v = TA.cross_memory(tp, _t(memory, tdt), cfg)
    assert k.shape == (2, cfg.n_kv_heads, M, cfg.head_dim) == v.shape and k.dtype == tdt
    assert _err(k, jk) < tol and _err(v, jv) < tol
    out = TA.cross_attention(tp, _t(x, tdt), (k, v), cfg)
    jout = RA.cross_attention(p, jnp.asarray(x, jdt), (jk, jv), ref_cfg)
    assert out.dtype == tdt and out.shape == (2, S, cfg.d_model)
    assert _err(out, jout) < tol
    # the gate scales the output: at 0 it adds nothing
    zero = TA.cross_attention({**tp, "gate": torch.zeros(())}, _t(x, tdt), (k, v), cfg)
    assert not bool(zero.any())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", LAYOUTS)
def test_cross_attention_decode_one_query(rng, arch, dtype):
    """Decode's cross-attention: one query row against the whole memory
    (M = 70).  Control: each sequence reading another's memory (the batch
    rolled by one) must read outside the limit."""
    jdt, tdt, tol = DTYPES[dtype]
    ref_cfg, cfg, p, tp = _params(arch, seed=2)
    memory = rng.normal(size=(3, 70, cfg.d_model)).astype(np.float32)
    mkv = TA.cross_memory(tp, _t(memory, tdt), cfg)
    jmkv = RA.cross_memory(p, jnp.asarray(memory, jdt), ref_cfg)
    shifted = TA.cross_memory(tp, _t(np.roll(memory, 1, axis=0), tdt), cfg)
    for _ in range(3):
        x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        jout = RA.cross_attention(p, jnp.asarray(x, jdt), jmkv, ref_cfg)
        assert _err(TA.cross_attention(tp, _t(x, tdt), mkv, cfg), jout) < tol
        assert _err(TA.cross_attention(tp, _t(x, tdt), shifted, cfg), jout) > tol


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_matches_reference(rng, monkeypatch, dtype):
    """seamless's 2-layer encoder (attention without the causal mask, then
    a dense MLP, a layer each) over 40 frames, in the compute dtype (the
    stack's: float32 patched into both packages, or bf16 as served)."""
    jdt, tdt, tol = DTYPES[dtype]
    monkeypatch.setattr(RT, "COMPUTE_DTYPE", jdt)
    monkeypatch.setattr(TT, "COMPUTE_DTYPE", tdt)
    ref_cfg, cfg = (smoke_config_for("seamless_m4t_large_v2"),
                    tconfigs.smoke_config_for("seamless_m4t_large_v2"))
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(4))
    port = params_from_reference(jax.tree.map(np.asarray, params), cfg, "cpu")
    frames = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    out = TT.encode(port.params, _t(frames), cfg)
    jout = RT.encode(params, jnp.asarray(frames), ref_cfg)
    assert out.dtype == tdt and out.shape == (2, 40, cfg.d_model)
    assert _err(out, jout) < tol
    # without the causal mask: the first frame's output reads the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    first = np.asarray(jout, np.float32)[:, :1]
    assert _err(TT.encode(port.params, _t(moved), cfg)[:, :1], first) > tol


def test_init_cache_memory_kv_shapes():
    """``init_cache``'s ``memory_kv`` for the cross layers (llama's fifth
    layer, seamless's every layer), at the reference's shapes without its
    stacked leading axis; no entry for a plain attention layer."""
    for arch in LAYOUTS:
        ref_cfg, cfg = smoke_config_for(arch), tconfigs.smoke_config_for(arch)
        ref = RT.init_cache(ref_cfg, 2, 32, 11)
        port = TT.init_cache(cfg, 2, 32, 11)
        assert len(port["layers"]) == cfg.n_repeats and port["pos"] == 0
        for block in port["layers"]:
            for name, spec in zip(block, cfg.super_block):
                want = ref["layers"][name]
                assert set(block[name]) == set(want), (arch, name)
                if spec.mixer == "cross" or spec.cross_memory:
                    for t, w in zip(block[name]["memory_kv"], want["memory_kv"]):
                        assert tuple(t.shape) == w.shape[1:] == (2, cfg.n_kv_heads, 11,
                                                                 cfg.head_dim)
                        assert t.dtype == torch.bfloat16 and not bool(t.any())


@pytest.mark.parametrize("arch", LAYOUTS)
def test_params_cross_both_ways(arch):
    """The encoder's nested ``blocks`` and the 0-d gates: carried across by
    ``params_from_reference`` (the module's names and values), back by
    ``tree_to_reference`` (bit for bit), and the port's own draw with the
    reference's names and shapes."""
    ref_cfg, cfg = smoke_config_for(arch), tconfigs.smoke_config_for(arch)
    ref = jax.tree.map(np.asarray, ref_build(ref_cfg).init(jax.random.PRNGKey(5)))
    ref = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full_like(a, GATE) if path[-1].key == "gate" else a, ref)
    model = params_from_reference(ref, cfg, "cpu")
    named = dict(model.named_parameters())
    gates = [n for n in named if n.endswith(".gate")]
    if arch == "llama32_vision_90b":
        assert gates == ["params.blocks.0.layer4.attn.gate"]
    else:
        assert gates == [f"params.blocks.{r}.layer0.xattn.gate" for r in range(cfg.n_repeats)]
        enc = ref["encoder"]["blocks"]["layer0"]
        for r in range(cfg.n_encoder_layers):
            np.testing.assert_array_equal(
                named[f"params.encoder.blocks.{r}.layer0.attn.wq"].numpy(),
                enc["attn"]["wq"][r])
        np.testing.assert_array_equal(named["params.encoder.final_norm"].numpy(),
                                      ref["encoder"]["final_norm"])
    assert all(named[n].dim() == 0 and float(named[n]) == float(np.float32(GATE)) for n in gates)
    back = tree_to_reference(unstack_blocks(ref))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # the port's own draw: the reference's names and shapes, gates 0-d zeros
    drawn = tree_to_reference(build_model(cfg, "cpu").init_params(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(drawn) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(drawn), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert len(dict(build_model(cfg, "cpu").init().named_parameters())) == len(named)


def test_memory_moves_the_logits_only_through_the_gates(rng):
    """With every gate at 0 (as drawn) llama-3.2-vision's logits do not
    depend on the memory; with the gates set they do.  (seamless's
    decoder reads its memory only through gated sublayers too.)"""
    for arch in LAYOUTS:
        cfg = tconfigs.smoke_config_for(arch)
        model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(6))
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32))
        M = cfg.vision_tokens or 12
        m1, m2 = (torch.as_tensor(rng.normal(size=(2, M, cfg.d_model)).astype(np.float32))
                  for _ in range(2))
        a, _ = model.prefill(toks, m1, max_len=16)
        b, _ = model.prefill(toks, m2, max_len=16)
        assert torch.equal(a, b), arch
        for name, p in model.named_parameters():
            if name.endswith(".gate"):
                p.data.fill_(GATE)
        a, _ = model.prefill(toks, m1, max_len=16)
        b, _ = model.prefill(toks, m2, max_len=16)
        assert float((a - b).abs().max()) > 2e-2 * float(a.abs().max()), arch


@pytest.mark.parametrize("arch", LAYOUTS)
def test_cross_configs_draw_the_published_shapes(arch):
    """The full configs at full width, depth cut to one super-block (and
    one encoder layer), drawn on ``meta`` (nothing allocated): every leaf
    at the reference's name and shape (``jax.eval_shape`` of its init),
    llama-3.2-vision's cross layer fifth, seamless's ``xattn`` in every
    decoder layer."""
    full = tconfigs.config_for(arch)
    cfg = dataclasses.replace(full, n_repeats=1, n_encoder_layers=min(full.n_encoder_layers, 1))
    ref_cfg = dataclasses.replace(smoke_config_for(arch), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "super_block"})
    want = ref_build(ref_cfg).init_shapes()
    drawn = TT.init_params(torch.Generator(), cfg, device="meta")
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                                 stack_blocks(drawn),
                                 is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert jax.tree.structure(got, is_leaf=lambda t: isinstance(t, tuple)) == \
        jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got, is_leaf=lambda t: isinstance(t, tuple))):
        assert g == (w.shape, "torch.float32"), path
    layer = "layer4" if arch == "llama32_vision_90b" else "layer0"
    assert "gate" in want["blocks"][layer]["attn" if arch == "llama32_vision_90b" else "xattn"]
