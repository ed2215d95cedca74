"""The port's plain flash_attention versions against the reference's Pallas
kernel (``flash_attention_pallas(..., interpret=True)``, as the reference's
own CPU tests run it) and its ``flash_attention_ref`` / ``_chunked``, on the
same inputs made with numpy from a seed.

Tolerances are the reference's (``tests/test_kernels.py``): 2e-5 absolute
and relative in float32, 2e-2 in bf16 (outputs compared as float32; the two
packages round the bf16 output from float32 sums taken in another order).
The CUDA kernel itself runs only on the card: ``test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import (flash_attention_chunked as jax_chunked,
                                               flash_attention_ref as jax_ref)
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_chunked,
                                                     flash_attention_ref)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(rng, B, Hq, Hk, Sq, Sk, D, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D))]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.as_tensor(a).to(tdt) for a in arrs]


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D", [
    (1, 4, 2, 128, 128, 64),
    (1, 4, 1, 96, 160, 64),   # lengths the blocks do not divide
    (1, 2, 1, 64, 320, 128),
    (1, 2, 2, 96, 160, 96),   # phi3-mini-3.8b's head dim, MHA
    (1, 4, 2, 64, 128, 256),  # gemma3-12b's head dim, GQA
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_ref(rng, B, Hq, Hk, Sq, Sk, D, causal, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Hq, Hk, Sq, Sk, D, dtype)
    tol = DTYPES[dtype][2]
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, interpret=True, bq=64, bk=64)
    ref = flash_attention_ref(q, k, v, causal=causal)
    chunked = flash_attention_chunked(q, k, v, causal=causal, bk=64)
    assert ref.dtype == chunked.dtype == q.dtype
    _close(ref, pallas, tol)
    _close(chunked, pallas, tol)
    _close(ref, jax_ref(jq, jk, jv, causal=causal), tol)
    _close(chunked, jax_chunked(jq, jk, jv, causal=causal, bk=64), tol)


@pytest.mark.parametrize("window", [32, 128])
def test_sliding_window(rng, window):
    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, 2, 2, 256, 256, 64, "float32")
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                    interpret=True, bq=64, bk=64)
    _close(flash_attention_ref(q, k, v, causal=True, window=window), pallas, 2e-5)
    _close(flash_attention_chunked(q, k, v, causal=True, window=window, bk=64), pallas, 2e-5)


def test_decode_offset(rng):
    """Sq = 1 with q_offset at the cache position (the serving decode shape)."""
    (jq, jk, jv), (q, k, v) = _inputs(rng, 2, 4, 2, 1, 512, 64, "float32")
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, q_offset=511, interpret=True)
    _close(flash_attention_ref(q, k, v, causal=True, q_offset=511), pallas, 2e-5)
    _close(flash_attention_chunked(q, k, v, causal=True, q_offset=511), pallas, 2e-5)


def test_rows_with_no_valid_key_are_zero(rng):
    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, 2, 1, 8, 16, 64, "float32")
    kw = dict(causal=False, window=4, q_offset=40)  # every key is too old
    for out in (flash_attention_ref(q, k, v, **kw), flash_attention_chunked(q, k, v, **kw)):
        assert not torch.isnan(out).any() and not out.any()
    assert not np.asarray(jax_ref(jq, jk, jv, **kw)).any()


@pytest.mark.parametrize("Sq,Sk", [(64, 96), (600, 600)])
def test_ops_picks_the_reference_form(rng, Sq, Sk):
    """On the CPU, ``ops.flash_attention`` takes the dense form up to 512 x 512
    scores and the chunked form above, as the reference's ops does off the
    TPU; it launches nothing."""
    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, 4, 2, Sq, Sk, 64, "float32")
    before = ops.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES == before
    _close(out, jax_flash(jq, jk, jv, causal=True), 2e-5)


def test_ops_has_no_fallback_off_the_cpu():
    q = torch.empty((1, 2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q[:, :1], q[:, :1])


def test_binding_head_dims_are_the_compiled_instances():
    """The binding's HEAD_DIMS are the head dims ``csrc/flash_attention.cu``
    instantiates, in float32 and in bf16 alike: every other D raises in the
    binding before it reaches the kernel."""
    import pathlib
    import re

    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

    src = (pathlib.Path(ops.__file__).resolve().parents[2] / "csrc" /
           "flash_attention.cu").read_text()
    cases = [int(c) for c in re.findall(r"case (\d+): return launch", src)]
    assert sorted(c for c in cases if c < 1000) == list(HEAD_DIMS) == [16, 64, 96, 128, 256]
    assert sorted(c - 1000 for c in cases if c >= 1000) == list(HEAD_DIMS)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 32), (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_head_dim_matches_pallas_at_24(rng, causal, window, dtype):
    """A head dim between the compiled instances (24, MLA's in minicpm3-4b's
    smoke config): the card pads q, k and v with zeros to the next instance
    (64), scales by 24 ** -0.5 and slices the output back. That arithmetic,
    here through the plain version, equals the reference's Pallas kernel
    run at D = 24."""
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, 4, 2, 96, 160, 24, dtype)
    Dp = ops.padded_head_dim(24, HEAD_DIMS)
    assert Dp == 64
    out = ops.pad_head_dim(flash_attention_ref, q, k, v, Dp, None, causal=causal,
                           window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    interpret=True, bq=64, bk=64)
    _close(out, pallas, DTYPES[dtype][2])
    # a caller's own scale is kept
    scaled = ops.pad_head_dim(flash_attention_ref, q, k, v, Dp, 0.3, causal=causal,
                              window=window)
    _close(scaled, flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                          sm_scale=0.3, interpret=True, bq=64, bk=64),
           DTYPES[dtype][2])


def test_padded_head_dim_picks_the_next_instance():
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

    assert [ops.padded_head_dim(d, HEAD_DIMS) for d in (1, 16, 17, 24, 64, 80, 96, 200, 256)] \
        == [16, 16, 64, 64, 64, 96, 96, 256, 256]
    with pytest.raises(ValueError, match=r"head dim 257 .*\(16, 64, 96, 128, 256\)"):
        ops.padded_head_dim(257, HEAD_DIMS)
