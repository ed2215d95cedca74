"""The port's mixture of experts (``repro_torch.models.layers``:
``init_moe``, ``moe``, ``moe_aux_loss``) against the reference's
(``src/repro/models/layers.py:71-131``) on the CPU, with the reference's
parameters carried across as numpy and inputs made with numpy from a seed.

Tolerances:
* float32: 1e-5 of the largest |value| (the same float32 arithmetic,
  summed in another order), for outputs, the auxiliary loss and gradients;
* which experts a token takes: equal, ties included (``jax.lax.top_k``
  puts the lower index first among equal weights; the port sorts stably).

Inputs whose router logits tie exactly: a zero router (every weight of a
row equal) and an integer router with a column repeated over integer
inputs, whose dot products are exact in float32 whatever the order of the
sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as TL

D, F, N_EXPERTS = 32, 48, 10


def _t(x):
    return torch.as_tensor(np.array(np.asarray(x, np.float32)))


def _tree(params):
    return {k: _t(v) for k, v in params.items()}


def _err(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max()) / (float(np.abs(j).max()) + 1e-9)


def _params(storage=None, seed=0):
    return RL.init_moe(jax.random.PRNGKey(seed), D, F, N_EXPERTS, storage)


def _tied(params, rng, k):
    """The reference's parameters with an integer router whose column 1
    repeats as column 4, so that the logits of integer inputs tie exactly
    between experts 1 and 4 on every row; its row 0 puts k - 1 other
    experts above those two, so that an input on dimension 0 alone has its
    tie at ranks k and k + 1, across the top k's edge."""
    router = rng.integers(-2, 3, size=(D, N_EXPERTS)).astype(np.float32)
    others = [e for e in range(N_EXPERTS) if e not in (1, 4)]
    router[0, others] = [10 - r if r < k - 1 else -5 for r in range(len(others))]
    router[0, 1] = 3
    router[:, 4] = router[:, 1]
    return {**params, "router": jnp.asarray(router)}


def _chosen(weights, k):
    """The experts ``jax.lax.top_k`` picks, lower index first among ties."""
    return np.asarray(jax.lax.top_k(jnp.asarray(weights), k)[1])


@pytest.mark.parametrize("storage", [None, 12])
def test_init_moe_shapes_and_padding_equal_the_reference(storage):
    ref = _params(storage)
    port = TL.init_moe(torch.Generator().manual_seed(0), D, F, N_EXPERTS, storage)
    assert set(port) == set(ref)
    for name in ref:
        assert tuple(port[name].shape) == ref[name].shape, name
        assert port[name].dtype == torch.float32
    E = storage or N_EXPERTS
    assert tuple(port["router"].shape) == (D, N_EXPERTS)  # pad experts are never routed
    for name in ("w_gate", "w_up", "w_down"):
        assert bool((port[name][N_EXPERTS:E] == 0).all())
        assert not bool((port[name][:N_EXPERTS] == 0).all(dim=(1, 2)).any())
        assert not np.asarray(ref[name][:N_EXPERTS] == 0).all(axis=(1, 2)).any()


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("storage", [None, 12])
@pytest.mark.parametrize("lead", [(7,), (2, 5)])
def test_moe_matches_reference(rng, lead, storage, k):
    p = _params(storage)
    x = rng.normal(size=lead + (D,)).astype(np.float32)
    out = TL.moe(_tree(p), _t(x), k)
    assert tuple(out.shape) == lead + (D,)
    assert _err(out, RL.moe(p, jnp.asarray(x), k)) < 1e-5
    assert abs(float(TL.moe_aux_loss(_tree(p), _t(x)))
               - float(RL.moe_aux_loss(p, jnp.asarray(x)))) < 1e-5


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("router", ["zero", "repeated_column"])
def test_moe_ties_pick_the_reference_experts(rng, router, k):
    """Rows of equal logits: the same output as the reference's, from the
    same experts (the lower index first), and the auxiliary loss's argmax
    on the first of equal probabilities."""
    p = _params(12)
    if router == "zero":
        p = {**p, "router": jnp.zeros((D, N_EXPERTS), jnp.float32)}
        x = rng.normal(size=(2, 6, D)).astype(np.float32)
    else:
        p = _tied(p, rng, k)
        x = rng.integers(-2, 3, size=(2, 6, D)).astype(np.float32)
        x[0, 0] = 0.0
        x[0, 0, 0] = 1.0
    weights = np.asarray(jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1))
    want = _chosen(weights, k)
    got = torch.sort(TL._router_probs(_tree(p), _t(x)), dim=-1, descending=True,
                     stable=True)[1][..., :k]
    np.testing.assert_array_equal(got.numpy(), want)
    if router == "repeated_column":
        # the tie is real, and row 0 breaks it at the top k's edge
        assert np.array_equal(weights[..., 1], weights[..., 4])
        assert 1 in want[0, 0] and 4 not in want[0, 0]
    assert _err(TL.moe(_tree(p), _t(x), k), RL.moe(p, jnp.asarray(x), k)) < 1e-5
    assert abs(float(TL.moe_aux_loss(_tree(p), _t(x)))
               - float(RL.moe_aux_loss(p, jnp.asarray(x)))) < 1e-5


def test_moe_pad_experts_are_never_routed(rng):
    """Pad experts get no combine weight: filling their weights with
    anything leaves the output as it was."""
    p = _params(12)
    x = _t(rng.normal(size=(9, D)).astype(np.float32))
    base = TL.moe(_tree(p), x, 8)
    filled = _tree(p)
    for name in ("w_gate", "w_up", "w_down"):
        filled[name][N_EXPERTS:] = 1.0
    assert torch.equal(TL.moe(filled, x, 8), base)


@pytest.mark.parametrize("k", [2, 8])
def test_moe_gradients_match_jax_grad(rng, k):
    """Gradients of a weighted sum of ``moe``'s output, with respect to the
    parameters and the input, against ``jax.grad`` of the reference's: they
    reach the router through the softmax and the chosen weights only."""
    p = _params(12)
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    w = rng.normal(size=(2, 5, D)).astype(np.float32)

    def ref_loss(params, xx):
        return jnp.sum(RL.moe(params, xx, k) * w)

    ref_gp, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = {name: v.requires_grad_() for name, v in _tree(p).items()}
    tx = _t(x).requires_grad_()
    (TL.moe(tp, tx, k) * _t(w)).sum().backward()
    for name in p:
        assert _err(tp[name].grad, ref_gp[name]) < 1e-5, name
    assert _err(tx.grad, ref_gx) < 1e-5
    # the aux loss: through the probabilities, not the argmax
    ref_ga = jax.grad(lambda params: RL.moe_aux_loss(params, jnp.asarray(x)))(p)["router"]
    router = _t(p["router"]).requires_grad_()
    TL.moe_aux_loss({"router": router}, _t(x)).backward()
    assert _err(router.grad, ref_ga) < 1e-5


def test_moe_bf16_matches_reference(rng):
    """bf16 activations as served: within 2e-2 of the largest |output|
    (``tests/test_torch_models.py``'s bf16 limit), the router in float32
    on both sides."""
    p = _params(12)
    x = rng.normal(size=(3, 4, D)).astype(np.float32)
    out = TL.moe(_tree(p), _t(x).to(torch.bfloat16), 2)
    assert out.dtype == torch.bfloat16
    assert _err(out, RL.moe(p, jnp.asarray(x, jnp.bfloat16), 2)) < 2e-2
