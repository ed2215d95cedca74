"""The port's multi-head latent attention (``repro_torch.models.attention``:
``init_mla``, ``mla_seq``, ``mla_decode``) against the reference's
(``src/repro/models/attention.py:127-241``) on the CPU, with the
reference's parameters carried across as numpy and inputs made with numpy
from a seed.  The reference's flash_attention takes its plain version on
the CPU, as the port's wrapper does on a CPU tensor.

Two sets of MLA dims on minicpm3-4b's smoke widths (d_model 64, 4 heads):
the smoke config's (qk_nope 16, qk_rope 8, v 16: v is padded to 24) and
the published ones (q_lora_rank 768, kv_lora_rank 256, qk_nope 64,
qk_rope 32, v 64: v is padded to 96, the kernel's instance on the card).

Tolerances: float32 within 1e-5 x max|output| (the same float32
arithmetic, summed in another order); bf16 activations within 2e-2 x
max|output| (both packages sum bf16 products in float32 but round at
other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import config_for, smoke_config_for
from repro.models import attention as RA
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dims: str):
    """minicpm3-4b's smoke config in both packages, with its own MLA dims
    (``"smoke"``) or the published ones (``"published"``)."""
    ref, port = smoke_config_for("minicpm3_4b"), tconfigs.smoke_config_for("minicpm3_4b")
    if dims == "published":
        full = config_for("minicpm3_4b")
        ref = dataclasses.replace(ref, mla=full.mla, head_dim=full.head_dim)
        port = dataclasses.replace(port, mla=tconfigs.config_for("minicpm3_4b").mla,
                                   head_dim=full.head_dim)
    return ref, port


def _params(rng, ref_cfg):
    """The reference's draw, with its two norms' weights made non-zero so
    that they take part."""
    p = RA.init_mla(jax.random.PRNGKey(4), ref_cfg)
    for name in ("q_norm", "kv_norm"):
        p[name] = jnp.asarray(rng.normal(size=p[name].shape) * 0.1, jnp.float32)
    return p, {k: torch.as_tensor(np.array(v)) for k, v in p.items()}


def _err(t, j):
    j = np.asarray(jnp.asarray(j, jnp.float32))
    return float(np.abs(t.float().numpy() - j).max()) / (float(np.abs(j).max()) + 1e-9)


@pytest.mark.parametrize("dims", ["smoke", "published"])
def test_init_mla_names_and_shapes_equal_the_reference(dims):
    ref_cfg, cfg = _cfgs(dims)
    ref = RA.init_mla(jax.random.PRNGKey(0), ref_cfg)
    port = TA.init_mla(torch.Generator().manual_seed(0), cfg)
    assert list(port) == list(ref)
    for name, value in ref.items():
        assert tuple(port[name].shape) == value.shape, name
        assert port[name].dtype == torch.float32
    for name in ("q_norm", "kv_norm"):
        assert not port[name].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("dims", ["smoke", "published"])
def test_mla_seq_matches_reference(rng, dims, q_offset, dtype):
    ref_cfg, cfg = _cfgs(dims)
    p, tp = _params(rng, ref_cfg)
    jdt, tdt = DTYPES[dtype]
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    o_ref, lat_ref = RA.mla_seq(p, jnp.asarray(x, jdt), ref_cfg, q_offset=q_offset)
    o, lat = TA.mla_seq(tp, torch.as_tensor(x).to(tdt), cfg, q_offset=q_offset)
    assert o.dtype == lat.dtype == tdt
    assert o.shape == o_ref.shape and lat.shape == lat_ref.shape
    assert _err(o, o_ref) < TOL[dtype]
    assert _err(lat, lat_ref) < TOL[dtype]
    # control: one position further on reads far outside the limit
    o_off, _ = TA.mla_seq(tp, torch.as_tensor(x).to(tdt), cfg, q_offset=q_offset + 1)
    assert _err(o_off, o_ref) > 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", ["smoke", "published"])
def test_mla_decode_matches_reference(rng, dims, dtype):
    """One decode step into a random 16-slot latent cache at pos 0, a
    middle slot, the last slot, and past the end (the write clamped to the
    last slot, every slot valid): the output and the cache."""
    ref_cfg, cfg = _cfgs(dims)
    p, tp = _params(rng, ref_cfg)
    jdt, tdt = DTYPES[dtype]
    m = cfg.mla
    S_cache = 16
    for pos in (0, 7, S_cache - 1, S_cache + 2):
        cache = rng.normal(size=(2, S_cache, m.kv_lora_rank + m.qk_rope_head_dim))
        cache = cache.astype(np.float32)
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        o_ref, c_ref = RA.mla_decode(p, jnp.asarray(x, jdt), jnp.asarray(cache, jdt), pos,
                                     ref_cfg)
        tc = torch.as_tensor(cache).to(tdt)
        o, c = TA.mla_decode(tp, torch.as_tensor(x).to(tdt), tc, pos, cfg)
        assert c is tc  # updated in place
        assert o.dtype == tdt and o.shape == o_ref.shape
        assert _err(o, o_ref) < TOL[dtype], pos
        assert _err(c, c_ref) < TOL[dtype], pos
        slot = min(pos, S_cache - 1)
        others = [i for i in range(S_cache) if i != slot]
        np.testing.assert_array_equal(c[:, others].float().numpy(),
                                      torch.as_tensor(cache).to(tdt)[:, others].float().numpy())


def test_model_names_the_mla_leaves_as_the_reference():
    """The serving model's module tree names the MLA leaves
    ``params.blocks.<r>.layer0.attn.<leaf>``, for its own draw and for the
    reference's carried across (whose values it holds), and its decode
    cache holds one latent (B, max_len, kv_rank + rope) a layer."""
    from repro.models import build_model as ref_build
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_reference

    ref_cfg, cfg = _cfgs("published")
    ref = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    want = {f"params.blocks.{r}.layer0.attn.{leaf}": np.asarray(w[r])
            for leaf, w in ref["blocks"]["layer0"]["attn"].items()
            for r in range(cfg.n_repeats)}
    assert "params.blocks.1.layer0.attn.w_ukv" in want
    for model in (build_model(cfg, "cpu").init(),
                  params_from_reference(jax.tree.map(np.asarray, ref), cfg, "cpu")):
        got = {n: p for n, p in model.named_parameters() if ".attn." in n}
        assert set(got) == set(want)
        for name, value in want.items():
            assert tuple(got[name].shape) == value.shape, name
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value)
    cache = model.init_cache(2, 32)
    assert [sorted(c["layer0"]) for c in cache["layers"]] == [["latent"]] * cfg.n_repeats
    assert cache["layers"][0]["layer0"]["latent"].shape == (2, 32, 256 + 32)
