"""The port's plain flash_attention versions against the reference's Pallas
kernel (``flash_attention_pallas(..., interpret=True)``, as the reference's
own CPU tests run it) and its ``flash_attention_ref`` / ``_chunked``, on the
same inputs made with numpy from a seed.

Tolerances are the reference's (``tests/test_kernels.py``): 2e-5 absolute
and relative in float32, 2e-2 in bf16 (outputs compared as float32; the two
packages round the bf16 output from float32 sums taken in another order).
The CUDA kernel itself runs only on the card: ``test_torch_kernels_card.py``.

Gradients (training): torch autograd of the port's plain versions against
``jax.grad`` of the reference's ``flash_attention_ref`` and
``flash_attention_chunked``, and ``flash_attention_bwd_ref`` (the backward
kernels' formulas) against torch autograd, in float32 within 1e-5 of
max |grad| (the same float32 arithmetic summed in another order).  A row
with no valid key is compared only against ``flash_attention_bwd_ref``:
both packages' dense forms take exp(-inf - -inf) there, so autograd's
gradient of such a row is NaN.  ``flash_attention_bwd_ref`` with
``round_to_bf16`` (P and dS rounded to bf16 before their products, the
bf16 tensor-core kernels' arithmetic) is held on bf16-rounded inputs to
jax.grad of the reference within 8e-3 of max |grad|, the card's bf16 limit.
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
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_chunked,
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


def test_ops_has_no_fallback_off_the_cpu(monkeypatch):
    """Off the CPU the plain version never runs: a ``meta`` tensor takes
    the card's path to the launch, where the kernel's fake version stands
    in (the dry run's trace), and counts no launch."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ops, "flash_attention_ref", plain)
    monkeypatch.setattr(ops, "flash_attention_chunked", plain)
    q = torch.empty((1, 2, 4, 64), device="meta")
    before = ops.LAUNCHES
    out = ops.flash_attention(q, q[:, :1], q[:, :1])
    assert out.device.type == "meta" and out.shape == q.shape
    assert ops.LAUNCHES == before


def test_ops_raise_on_a_device_without_a_kernel():
    """A tensor neither on the CPU, on the card nor on ``meta`` raises
    before anything runs: no plain version, no launch."""
    from types import SimpleNamespace

    q = SimpleNamespace(device=torch.device("xpu"), shape=(1, 2, 4, 64))
    before = ops.LAUNCHES
    with pytest.raises(ValueError, match="no kernel for xpu"):
        ops.flash_attention(q, q, q)
    assert ops.LAUNCHES == before


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


def _grel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,kw", [
    (1, 4, 2, 40, 40, 16, dict(causal=True)),
    (2, 4, 1, 24, 56, 64, dict(causal=True, window=16, q_offset=32)),
    (1, 2, 2, 33, 33, 96, dict(causal=False)),
])
def test_plain_autograd_matches_jax_grad(rng, B, Hq, Hk, Sq, Sk, D, kw):
    """Autograd of the port's dense and chunked forms against jax.grad of
    the reference's, for loss = sum(out * w)."""
    import jax

    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D), (B, Hq, Sq, D))]
    w = arrs[3]
    for port_fn, jax_fn, extra in ((flash_attention_ref, jax_ref, {}),
                                   (flash_attention_chunked, jax_chunked, {"bk": 16})):
        want = jax.grad(lambda q, k, v: (jax_fn(q, k, v, **kw, **extra) * w).sum(),
                        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs[:3]))
        q, k, v = (torch.as_tensor(a).requires_grad_() for a in arrs[:3])
        got = torch.autograd.grad((port_fn(q, k, v, **kw, **extra) * torch.as_tensor(w)).sum(),
                                  (q, k, v))
        for a, b in zip(got, want):
            assert _grel(a.numpy(), b) < 1e-5, (port_fn.__name__, _grel(a.numpy(), b))


@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,kw", [
    (1, 4, 2, 37, 37, 16, dict(causal=True)),                       # GQA, ragged
    (2, 4, 4, 50, 50, 64, dict(causal=True, window=12)),             # window, MHA
    (1, 4, 1, 20, 70, 16, dict(causal=True, q_offset=50)),           # q_offset
    (1, 2, 1, 30, 45, 64, dict(causal=False, sm_scale=0.3)),
])
def test_bwd_ref_matches_autograd(rng, B, Hq, Hk, Sq, Sk, D, kw):
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32).requires_grad_()
               for s in ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D)))
    do = torch.as_tensor(rng.normal(size=(B, Hq, Sq, D)), dtype=torch.float32)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), lse, do, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _grel(a, b) < 1e-5
    # lse against torch.logsumexp of the masked scores
    n_rep = Hq // Hk
    s = torch.einsum("bhqd,bhkd->bhqk", q.detach(), k.detach().repeat_interleave(n_rep, 1))
    s = s * kw.get("sm_scale", D ** -0.5)
    qpos = kw.get("q_offset", 0) + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = (kpos <= qpos) if kw["causal"] else torch.ones((Sq, Sk), dtype=torch.bool)
    if "window" in kw:
        mask &= kpos > qpos - kw["window"]
    want_lse = torch.logsumexp(torch.where(mask, s, float("-inf")), dim=-1)
    assert torch.isfinite(lse).all() and _grel(lse, want_lse) < 1e-6


def test_bwd_ref_through_the_head_dim_padding(rng):
    """D = 24 on the card runs at 64, q, k, v zero-padded and the scale
    kept at 24's: the backward formulas at 64, their gradients sliced back,
    equal autograd of the plain version at 24."""
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32).requires_grad_()
               for s in ((1, 4, 40, 24), (1, 2, 40, 24), (1, 2, 40, 24)))
    do = torch.as_tensor(rng.normal(size=(1, 4, 40, 24)), dtype=torch.float32)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal=True, window=9), (q, k, v),
                               do)
    pad = lambda t: torch.nn.functional.pad(t.detach(), (0, 40))  # noqa: E731
    o, lse = flash_attention_ref(pad(q), pad(k), pad(v), causal=True, window=9,
                                 sm_scale=24 ** -0.5, return_lse=True)
    got = flash_attention_bwd_ref(pad(q), pad(k), pad(v), o, lse, pad(do), causal=True,
                                  window=9, sm_scale=24 ** -0.5)
    for a, b in zip(got, want):
        assert not a[..., 24:].any()
        assert _grel(a[..., :24], b) < 1e-5


def test_bwd_ref_fully_masked_rows_are_zero(rng):
    """Every key too old for every row: lse = -inf and zero gradients
    (autograd of the dense form gives NaN there)."""
    q, k, v, do = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                   for s in ((1, 2, 8, 16), (1, 1, 16, 16), (1, 1, 16, 16), (1, 2, 8, 16)))
    kw = dict(causal=False, window=4, q_offset=40)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.isneginf(lse).all() and not o.any()
    for g in flash_attention_bwd_ref(q, k, v, o, lse, do, **kw):
        assert not torch.isnan(g).any() and not g.any()


#: chip_smoke.py's FLASH_BWD_TOL["bfloat16"]: the card holds the bf16
#: backward kernels to the float32 plain version within 8e-3 of max |grad|
BWD_BF16_TOL = 8e-3


def _bf16_values(rng, shapes):
    """Normal draws rounded to bf16 once, held as float32 (torch tensors and
    the same values as numpy arrays for JAX)."""
    arrs = [torch.as_tensor(rng.normal(size=s).astype(np.float32)).bfloat16().float()
            for s in shapes]
    return [t.numpy() for t in arrs], arrs


@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,kw", [
    (1, 4, 4, 77, 77, 16, dict(causal=True)),                          # MHA, ragged
    (1, 8, 2, 100, 130, 64, dict(causal=True)),                        # GQA n_rep 4
    (2, 4, 1, 45, 150, 64, dict(causal=True, window=40, q_offset=105)),  # window, offset
    (1, 4, 4, 70, 90, 16, dict(causal=False)),
])
def test_bwd_ref_bf16_rounding_matches_jax_grad(rng, B, Hq, Hk, Sq, Sk, D, kw):
    """``flash_attention_bwd_ref(..., round_to_bf16=True)``, the tensor-core
    kernels' arithmetic (P and dS rounded to bf16 before their products), on
    bf16-rounded inputs, against jax.grad of the reference's float32
    ``flash_attention_ref`` on the same values: within the card's bf16
    limit.  Gradients and O stay float32 here, so the comparison sees the
    rounding of P and dS alone.  The rounding is taken (the result differs
    from the unrounded form's)."""
    import jax

    (nq, nk, nv, ndo), (q, k, v, do) = _bf16_values(
        rng, ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D), (B, Hq, Sq, D)))
    want = jax.grad(lambda q, k, v: (jax_ref(q, k, v, **kw) * ndo).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (nq, nk, nv)))
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, round_to_bf16=True, **kw)
    unrounded = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, b in zip(got, want):
        assert _grel(a.numpy(), b) < BWD_BF16_TOL, _grel(a.numpy(), b)
    assert not all(torch.equal(a, b) for a, b in zip(got, unrounded))


def test_bwd_ref_bf16_rounding_through_the_head_dim_padding(rng):
    """D = 24 padded to 64 (the card's bf16 instance), P and dS rounded to
    bf16: the gradients sliced back are within the card's bf16 limit of
    jax.grad of the reference at 24, and the padded columns are zero."""
    import jax

    kw = dict(causal=True, window=9)
    (nq, nk, nv, ndo), (q, k, v, do) = _bf16_values(
        rng, ((1, 4, 50, 24), (1, 1, 50, 24), (1, 1, 50, 24), (1, 4, 50, 24)))
    want = jax.grad(lambda q, k, v: (jax_ref(q, k, v, **kw) * ndo).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (nq, nk, nv)))
    pad = lambda t: torch.nn.functional.pad(t, (0, 40))  # noqa: E731
    o, lse = flash_attention_ref(pad(q), pad(k), pad(v), sm_scale=24 ** -0.5,
                                 return_lse=True, **kw)
    got = flash_attention_bwd_ref(pad(q), pad(k), pad(v), o, lse, pad(do),
                                  sm_scale=24 ** -0.5, round_to_bf16=True, **kw)
    for a, b in zip(got, want):
        assert not a[..., 24:].any()
        assert _grel(a[..., :24].numpy(), b) < BWD_BF16_TOL
