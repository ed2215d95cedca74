"""Training on the port (``repro_torch.train``, ``dist/compress.py``,
``models.layers.chunked_softmax_xent``, ``transformer.loss_fn``) on the
CPU: the cases of ``tests/test_train_runtime.py`` that hold on the port,
and parity with the reference on the same inputs (made with numpy or drawn
by the reference and carried across with ``state_from_reference``).

Tolerances, each with its reason:
* ``lr_schedule``, ``global_norm``, ``adamw_update``: 1e-6 relative (the
  same float32 operations; the sum of squares is taken in another order);
* ``compress_tree`` / ``ef_quantize``: bit-equal (the same float32 max,
  divide and round-half-to-even);
* ``chunked_softmax_xent`` in float32: 1e-5 of max |value| or |grad| (the
  same float32 arithmetic summed in another order);
* ``loss_fn`` in float32 compute (``COMPUTE_DTYPE`` patched in both
  packages): loss 1e-5 relative, each gradient leaf within 1e-4 of its max;
  in bf16, as the reference computes: loss 1e-4 relative, gradients 3e-2
  of each leaf's max (JAX and torch round bf16 products at other places,
  and a backward rounds about twice as often as a forward's 2e-2);
* 8 ``train_loop`` steps from one carried-across state over the same
  batches: each step's loss within 1e-3 relative; final parameters within
  4e-3 absolute (about half the 8 steps' summed learning rate, 7.5e-3:
  AdamW moves a coordinate by up to ~lr a step whatever the gradient's
  size, so a coordinate whose tiny gradient rounds differently may drift
  by a step's worth) and 1e-4 in mean (1.3% of the summed learning rate:
  bf16 gradients 1-2% apart move AdamW's normalized step as much).
A control that must fail each loss tolerance is checked beside it.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ssd_scan.ops as jax_ssd_ops
import repro.kernels.ssd_scan.ref as jax_ssd_ref
import repro.models.ssm as RSSM
import repro.models.transformer as RT
import repro_torch.models.transformer as TT
from repro.configs import smoke_config_for
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.dist import compress as RC
from repro.models import build_model as ref_build
from repro.models.layers import chunked_softmax_xent as ref_xent
from repro.train import optim as RO
from repro.train.train_loop import init_state as ref_init_state
from repro.train.train_loop import train_loop as ref_train_loop
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import DataPipeline
from repro_torch.dist import compress as TC
from repro_torch.dist.compress import init_error_tree
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import state_from_reference, tree_to_reference
from repro_torch.models.layers import chunked_softmax_xent
from repro_torch.train import optim as TO
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import plan_remesh, reshard_state, usable_devices
from repro_torch.train.straggler import StragglerConfig, StragglerTracker
from repro_torch.train.train_loop import (TrainState, compute_params, init_state,
                                          make_train_step, train_loop)
from repro_torch.tree import tree_leaves, tree_unflatten


def _model_and_state(arch="granite3_2b", seed=0, compress=False):
    """The reference's test setup on the port: its initial parameters
    (``PRNGKey(seed)``) carried across, so each case starts where the
    reference's own does (the synthetic tokens are uniform, so the loss
    starts near its floor, ln(vocab), and a decrease over 8 steps is a
    property of the start as much as of the optimizer)."""
    _, (model, opt_cfg, state), cfg = _carried(seed)
    if compress:
        state.ef_error = init_error_tree(state.params)
    return model, opt_cfg, state, cfg


def _pipeline(cfg, batch=4, seq=32):
    return DataPipeline(batch=batch, seq_len=seq, vocab=cfg.vocab, seed=1, device="cpu")


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


#: the value every cross-attention gate is set to (a fresh gate is 0, and
#: tanh(0) = 0 would hide cross-attention and give the rest of its layer
#: no gradient)
GATE = 1.0


def _gated(tree):
    """The reference's tree with every ``gate`` leaf set to :data:`GATE`."""
    return {k: _gated(v) if isinstance(v, dict)
            else (jnp.full_like(v, GATE) if k == "gate" else v) for k, v in tree.items()}


def _gates(tree) -> list:
    """The ``gate`` leaves of a reference-layout tree, in order."""
    return [x for k, v in tree.items()
            for x in (_gates(v) if isinstance(v, dict) else [v] if k == "gate" else [])]


def _carried(seed=0, arch="granite3_2b"):
    """The reference's model, optimizer config and fresh state (its gates,
    where it has any, at :data:`GATE`), and the same state carried across
    to the port."""
    ref_cfg, cfg = smoke_config_for(arch), tconfigs.smoke_config_for(arch)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    ref_model = ref_build(ref_cfg)
    ref_state = ref_init_state(ref_model, jax.random.PRNGKey(seed), RO.AdamWConfig(**kw))
    ref_state.params = _gated(ref_state.params)
    state = state_from_reference(
        {"params": jax.tree.map(_np, ref_state.params), "opt": jax.tree.map(_np, ref_state.opt)},
        cfg, "cpu")
    return (ref_model, RO.AdamWConfig(**kw), ref_state), (build_model(cfg, "cpu"),
                                                          TO.AdamWConfig(**kw), state), cfg


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


# ---------------------------------------------------------------------------
# the reference's runtime cases on the port
# ---------------------------------------------------------------------------


def test_train_loop_loss_decreases():
    model, opt_cfg, state, cfg = _model_and_state()
    step = make_train_step(model, opt_cfg)
    losses = []
    it = iter(_pipeline(cfg))
    for _ in range(8):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses))
    assert int(state.opt["step"]) == 8 and state.opt["step"].dtype == torch.int32


def test_microbatch_equivalence():
    """Grad accumulation over 4 microbatches == single big batch (loss)."""
    model, opt_cfg, state, cfg = _model_and_state()
    batch = next(iter(_pipeline(cfg, batch=8)))
    s1, m1 = make_train_step(model, opt_cfg, microbatches=1)(state, batch)
    _, _, state2, _ = _model_and_state()
    s2, m2 = make_train_step(model, opt_cfg, microbatches=4)(state2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=2e-2)
    a, b = tree_leaves(s1.params)[0], tree_leaves(s2.params)[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2)


def test_compressed_training_converges():
    model, opt_cfg, state, cfg = _model_and_state(compress=True)
    step = make_train_step(model, opt_cfg, compress=True)
    it = iter(_pipeline(cfg))
    losses = []
    for _ in range(8):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state.ef_error))


def test_quantization_error_bound(rng):
    x = torch.as_tensor(rng.normal(size=(1000,)) * 5, dtype=torch.float32)
    q, s = TC.quantize_int8(x)
    err = (TC.dequantize_int8(q, s) - x).abs().numpy()
    assert err.max() <= float(s) / 2 + 1e-6  # half-ulp bound
    e0 = torch.as_tensor(rng.normal(size=(1000,)) * 0.01, dtype=torch.float32)
    q2, s2, e1 = TC.ef_quantize(x, e0)
    np.testing.assert_allclose((TC.dequantize_int8(q2, s2) + e1).numpy(), (x + e0).numpy(),
                               rtol=1e-5)


def test_straggler_policy():
    tr = StragglerTracker(StragglerConfig(alpha=1.0, threshold=1.5, patience=3))
    for step in range(6):
        for host in range(8):
            tr.record(host, step, 1.0 if host != 3 else 2.5)
    assert tr.should_evict() == {3}
    tr2 = StragglerTracker(StragglerConfig(alpha=1.0, threshold=1.5, patience=3))
    for step in range(6):
        for host in range(8):
            tr2.record(host, step, 2.5 if (host == 3 and step == 2) else 1.0)
    assert tr2.should_evict() == set()


def test_elastic_remesh_plans():
    assert plan_remesh(256, model_axis=16).shape == (16, 16)
    assert plan_remesh(216, model_axis=16).shape == (13, 16)
    assert usable_devices(216, 16) == 208
    assert plan_remesh(512, model_axis=16, pods=2).shape == (2, 16, 16)
    with pytest.raises(ValueError):
        plan_remesh(8, model_axis=16)
    mesh = plan_remesh(4, model_axis=1).build(["cpu"] * 4)
    assert dict(mesh.shape) == {"data": 4, "model": 1}


def test_elastic_checkpoint_restart(tmp_path):
    """Train, checkpoint, restore onto a new topology (four mesh positions
    over the CPU) and keep training."""
    model, opt_cfg, state, cfg = _model_and_state()
    pipe = _pipeline(cfg)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    state = train_loop(model, state, iter(pipe), opt_cfg, steps=2,
                       checkpoint_mgr=mgr, checkpoint_every=2, log_every=0)
    step, restored = mgr.restore_latest()
    assert step == 2
    mesh = make_small_mesh(data=4, devices=["cpu"] * 4)
    params2 = reshard_state(restored["params"], mesh, cfg)
    for a, b in zip(tree_leaves(params2), tree_leaves(state.params)):
        assert torch.equal(a, b)
    state2 = train_loop(model, TrainState(params2, restored["opt"], None), iter(pipe),
                        opt_cfg, steps=4, log_every=0)
    assert int(state2.opt["step"]) == 4


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    for kw in (dict(), dict(warmup_steps=5, total_steps=50, lr=1e-3, min_lr_ratio=0.2)):
        rc, tc = RO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
        for s in (0, 1, 3, 5, 6, 27, 50, 51, 200, 10_000, 12_000):
            want = float(RO.lr_schedule(rc, s))
            got = TO.lr_schedule(tc, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6 * abs(want), (kw, s)


def _opt_trees(rng, moment):
    shapes = {"w": (6, 5), "b": (5,), "layers": [{"k": (3, 4, 2)}, {"k": (3, 4, 2)}]}

    def draw(scale, dtype=np.float32):
        return jax.tree.map(lambda s: (rng.normal(size=s) * scale).astype(dtype), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))

    p, g = draw(1.0), draw(3.0)
    m = jax.tree.map(lambda a: jnp.asarray(a, moment), draw(0.1))
    v = jax.tree.map(lambda a: jnp.asarray(np.abs(a), moment), draw(0.01))
    return p, g, m, v


@pytest.mark.parametrize("moment,clip", [("bfloat16", 1.0), ("float32", 1e6)])
def test_adamw_update_matches_reference(rng, moment, clip):
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20, moment_dtype=moment, clip_norm=clip)
    p, g, m, v = _opt_trees(rng, jnp.dtype(moment))
    step = jnp.asarray(3, jnp.int32)
    rp, ropt, rmet = RO.adamw_update(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
                                     {"m": m, "v": v, "step": step}, RO.AdamWConfig(**kw))
    t = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: torch.from_numpy(_np(a).view(np.int16).copy()).view(torch.bfloat16)
        if np.asarray(a).dtype.name == "bfloat16" else torch.as_tensor(np.array(a)), tree)
    tp, topt, tmet = TO.adamw_update(t(p), t(g), {"m": t(m), "v": t(v),
                                                  "step": torch.tensor(3, dtype=torch.int32)},
                                     TO.AdamWConfig(**kw))
    assert int(topt["step"]) == 4 and topt["step"].dtype == torch.int32
    assert _rel(float(tmet["grad_norm"]), float(rmet["grad_norm"])) < 1e-6
    assert _rel(float(tmet["lr"]), float(rmet["lr"])) < 1e-6
    assert _rel(float(TO.global_norm(t(g))), float(RO.global_norm(g))) < 1e-6
    for ours, ref in ((tp, rp), (topt["m"], ropt["m"]), (topt["v"], ropt["v"])):
        ours = tree_to_reference(ours)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            b = _np(b)
            assert a.dtype == b.dtype
            if b.dtype == np.uint16:  # bf16 moments: at most one bf16 ulp apart
                a = a.view(np.int16).astype(np.int32)
                b = b.view(np.int16).astype(np.int32)
                assert np.abs(a - b).max() <= 1
            else:
                assert _rel(a, b) < 1e-6


def test_compression_is_bit_equal(rng):
    grads = {"emb": rng.normal(size=(7, 5)).astype(np.float32),
             "near_empty": np.concatenate([np.zeros((2, 3)), rng.normal(size=(2, 3))])
             .astype(np.float32),
             "vec": rng.normal(size=(9,)).astype(np.float32) * 3,
             "blocks": [{"k": rng.normal(size=(3, 2, 4)).astype(np.float32)}]}
    ef = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32), grads)
    (rcodes, rscales), ref = RC.compress_tree(jax.tree.map(jnp.asarray, grads),
                                              jax.tree.map(jnp.asarray, ef))
    t = lambda tree: jax.tree.map(lambda a: torch.as_tensor(a), tree)  # noqa: E731
    (codes, scales), new = TC.compress_tree(t(grads), t(ef))
    for ours, theirs in ((codes, rcodes), (scales, rscales), (new, ref),
                         (TC.decompress_tree((codes, scales)),
                          RC.decompress_tree((rcodes, rscales)))):
        for a, b in zip(tree_leaves(ours), jax.tree.leaves(theirs)):
            assert np.array_equal(a.numpy(), np.asarray(b)), (a, b)
    x, e = grads["vec"], ef["vec"]
    for a, b in zip(TC.ef_quantize(torch.as_tensor(x), torch.as_tensor(e)),
                    RC.ef_quantize(jnp.asarray(x), jnp.asarray(e))):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("with_mask", [False, True])
def test_chunked_softmax_xent_matches_reference(rng, with_mask):
    """S = 37 over chunks of 8 (padded), float32: value and gradients."""
    x = rng.normal(size=(2, 37, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 50)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 37)).astype(np.int32)
    mask = rng.random((2, 37)) > 0.3 if with_mask else None
    rv, (rgx, rgw) = jax.value_and_grad(
        lambda a, b: ref_xent(a, b, jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask), chunk=8),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.as_tensor(a).requires_grad_() for a in (x, w))
    val = chunked_softmax_xent(tx, tw, torch.as_tensor(labels),
                               None if mask is None else torch.as_tensor(mask), chunk=8)
    val.backward()
    assert _rel(float(val.detach()), float(rv)) < 1e-5
    assert _rel(tx.grad.numpy(), rgx) < 1e-5 and _rel(tw.grad.numpy(), rgw) < 1e-5
    # control: the labels one position off must read far outside the limit
    off = chunked_softmax_xent(tx, tw, torch.as_tensor(np.roll(labels, 1, axis=1)),
                               None if mask is None else torch.as_tensor(mask), chunk=8)
    assert _rel(float(off.detach()), float(rv)) > 1e-3


def _ref_loss_and_grads(ref_model, params, batch, cast: bool):
    def loss(p):
        if cast:
            p = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                             if (x.dtype == jnp.float32 and x.ndim >= 2) else x, p)
        return ref_model.loss_fn(p, batch)

    return jax.value_and_grad(loss)(params)


def _loss_and_grads_match(monkeypatch, compute, arch="granite3_2b", seq=40, grad_tol=None):
    """``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    reference's, from one carried-across state over one batch of ``seq``
    tokens, in float32 or bf16 compute; and a control.  ``grad_tol``
    replaces the gradients' limit."""
    (ref_model, _, ref_state), (model, _, state), cfg = _carried(arch=arch)
    if arch == "mamba2_370m" and seq > 64:
        # above 64 steps the reference differentiates its chunked form,
        # whose gradient is NaN where a chunk's decay above the diagonal
        # overflows (ROADMAP C10; tests/test_torch_ssd_scan.py shows it):
        # hold the port to the reference's own per-step recurrence there,
        # called un-jitted so that no cached trace keeps the chunked form
        monkeypatch.setattr(jax_ssd_ops, "ssd_scan_chunked",
                            lambda xdt, dtA, B, C, n_rep, chunk=128:
                            jax_ssd_ref.ssd_scan_ref(xdt, dtA, B, C, n_rep))
        monkeypatch.setattr(RSSM, "ssd_scan", jax_ssd_ops.ssd_scan.__wrapped__)
    if compute == "float32":
        monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(TT, "COMPUTE_DTYPE", torch.float32)
    ref_batch = RefPipeline(batch=4, seq_len=seq, vocab=cfg.vocab, seed=2).batch_at(0)
    batch = DataPipeline(batch=4, seq_len=seq, vocab=cfg.vocab, seed=2, device="cpu").batch_at(0)
    memory = _memory(cfg, seq, seed=3)
    if memory is not None:
        ref_batch = {**ref_batch, "memory": jnp.asarray(memory)}
        batch = {**batch, "memory": torch.as_tensor(memory)}
    cast = compute == "bfloat16"
    rv, rg = _ref_loss_and_grads(ref_model, ref_state.params, ref_batch, cast)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
    masters = tree_unflatten(state.params, leaves)
    val = model.loss_fn(compute_params(masters) if cast else masters, batch)
    val.backward()
    loss_tol, default_tol = (1e-5, 1e-4) if compute == "float32" else (1e-4, 3e-2)
    grad_tol = grad_tol or default_tol
    assert _rel(float(val.detach()), float(rv)) < loss_tol
    grads = tree_to_reference(tree_unflatten(state.params, [p.grad for p in leaves]))
    errs = [_rel(a, b) for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(rg))]
    assert max(errs) < grad_tol, errs
    # control: the next batch's loss reads outside the loss limit
    nxt = DataPipeline(batch=4, seq_len=seq, vocab=cfg.vocab, seed=2, device="cpu").batch_at(1)
    other = model.loss_fn(masters, nxt if memory is None else {**nxt, "memory": batch["memory"]})
    assert _rel(float(other.detach()), float(rv)) > loss_tol
    if memory is not None:
        # the gates' gradients are among the leaves compared above, and not 0
        assert _gates(grads) and all(float(np.abs(g).max()) > 0 for g in _gates(grads))
        # control: the memory redrawn moves the loss outside its limit
        redrawn = model.loss_fn(masters, {**batch, "memory": torch.as_tensor(
            _memory(cfg, seq, seed=4))})
        assert _rel(float(redrawn.detach()), float(rv)) > loss_tol


def _memory(cfg, seq: int, seed: int):
    """A memory input (4, M, D) as float32 numpy from ``seed``, unit scale:
    vision patches or audio frames as long as the tokens; None for a
    decoder."""
    M = cfg.vision_tokens or (seq if cfg.n_encoder_layers else 0)
    if not M:
        return None
    return np.random.default_rng(seed).normal(size=(4, M, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_fn_and_gradients_match_reference(monkeypatch, compute):
    _loss_and_grads_match(monkeypatch, compute)


#: mamba at 130 tokens, where the port differentiates its chunked form and
#: the reference its recurrence (C10): float32 3e-4 (the two forms sum
#: in another order; measured 1.4e-4, on ``A_log``, whose gradient sums
#: ddtA over every position and head; the port's own recurrence is within
#: 1.4e-6), bf16 5e-2 (measured 3.9e-2 on ``A_log``, 4.1e-2 with the port's
#: recurrence: bf16 rounded at other places, as in the dense case, on a
#: sum that cancels; every other leaf within 3.6e-2)
MAMBA_CHUNKED_GRAD_TOL = {"float32": 3e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("seq", [40, 130])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba_loss_fn_and_gradients_match_reference(monkeypatch, compute, seq):
    """mamba2-370m's smoke config at 40 tokens (the per-step recurrence on
    both sides; the dense case's limits) and 130 (the port's chunked form,
    ragged at its chunk of 128, against the reference's recurrence;
    :data:`MAMBA_CHUNKED_GRAD_TOL`)."""
    _loss_and_grads_match(monkeypatch, compute, "mamba2_370m", seq,
                          MAMBA_CHUNKED_GRAD_TOL[compute] if seq > 64 else None)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "jamba15_large_398b"])
def test_moe_loss_fn_and_gradients_match_reference(monkeypatch, arch):
    """The mixture-of-experts stacks' smoke configs at 40 tokens in float32
    compute, the dense case's float32 limits: granite-moe (8 experts, top 4)
    and jamba's hybrid stack (Mamba and attention layers, MoE on alternate
    ones).  Not in bf16: there a token whose k-th and (k + 1)-th router
    weights lie within bf16 rounding of each other takes another expert in
    one package than in the other, a step in the loss and not a rounding
    (measured: the loss 2.6e-3 apart for both archs against the jitted
    reference, 160 tokens x 2 or 4 MoE layers; granite-moe's equal to the
    un-jitted reference's within 1e-4)."""
    _loss_and_grads_match(monkeypatch, "float32", arch)


@pytest.mark.parametrize("arch", ["llama32_vision_90b", "seamless_m4t_large_v2"])
def test_cross_loss_fn_and_gradients_match_reference(monkeypatch, arch):
    """The cross-attention archs' smoke configs with ``batch["memory"]``
    (llama-3.2-vision: 8 patches through one cross layer; seamless: 40
    frames through its 2-layer encoder, then a cross sublayer in each
    decoder layer) at 40 tokens, the gates at :data:`GATE`, in float32
    compute at the dense case's float32 limits: every leaf's gradient, the
    gates' and the encoder's included; a redrawn memory as a second
    control.

    Not in bf16 (measured against the jitted reference; the un-jitted one
    in brackets).  The loss lies 9.5e-5 (1.8e-7) apart for llama and
    1.28e-4 (1.76e-4) for seamless, about the dense case's 1e-4, and the
    gradients' worst leaf 3.4e-2 (0.7e-2) and 3.0e-2 (1.7e-2) x its max,
    about its 3e-2.  A gate's gradient is one sum over B x S x D bf16
    products that nearly cancel, and no bf16 run holds it to a few percent.
    The float32 reference gives -3.92e-4 for llama's gate and -1.53e-3,
    -1.63e-3 for seamless's two.  The port's bf16 gives -4.74e-4 and
    -1.91e-3, -1.28e-3.  The reference's own bf16 gives 0.0 (-3.20e-4) and
    -5.95e-3, -0.87e-3 (-6.36e-3, -1.54e-3)."""
    _loss_and_grads_match(monkeypatch, "float32", arch)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mla_loss_fn_and_gradients_match_reference(monkeypatch, compute):
    """minicpm3-4b's smoke config (multi-head latent attention: qk 16 + 8,
    v 16 zero-padded to 24 for flash_attention) at 40 tokens, the dense
    case's limits in both computes."""
    _loss_and_grads_match(monkeypatch, compute, "minicpm3_4b")


#: final parameters after 8 steps, (max, mean) absolute.  mamba: 6e-3 and
#: 2e-4 (0.8 and 2.7% of the summed learning rate; measured 4.25e-3 on
#: ``w_in`` and 1.35e-4: as in the dense case, a coordinate whose tiny
#: gradient rounds differently moves by up to a step's lr, and its D, A_log
#: and dt_bias, 1-d float32 leaves that gather the whole sequence's
#: gradient, move further in mean)
TRAIN_PARAM_TOL = {"granite3_2b": (4e-3, 1e-4), "mamba2_370m": (6e-3, 2e-4)}


def _train_loop_matches(arch):
    """8 steps from one state over the same batches: per-step losses and
    the final parameters and moments."""
    (ref_model, ref_opt, ref_state), (model, opt_cfg, state), cfg = _carried(arch=arch)
    ref_losses = []
    ref_final = ref_train_loop(
        ref_model, ref_state, iter(RefPipeline(batch=4, seq_len=32, vocab=cfg.vocab, seed=1)),
        ref_opt, steps=8, log_every=1,
        log=lambda s: ref_losses.append(float(s.split("loss=")[1].split()[0])))
    history = []
    final = train_loop(model, state, iter(_pipeline(cfg)), opt_cfg, steps=8, log_every=0,
                       history=history)
    losses = [h["loss"] for h in history]
    # the reference logs its losses to 4 decimals
    assert all(abs(a - b) <= 1e-3 * abs(b) + 5e-5 for a, b in zip(losses, ref_losses)), \
        (losses, ref_losses)
    assert abs(losses[1] - ref_losses[0]) > 1e-3 * abs(ref_losses[0])  # control
    ours = jax.tree.leaves(tree_to_reference(final.params))
    theirs = [np.asarray(a) for a in jax.tree.leaves(ref_final.params)]
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(ours, theirs)])
    max_tol, mean_tol = TRAIN_PARAM_TOL[arch]
    assert diffs.max() < max_tol and diffs.mean() < mean_tol, (diffs.max(), diffs.mean())
    assert int(final.opt["step"]) == int(ref_final.opt["step"]) == 8
    # the state passed in is consumed, as the reference donates it
    assert final is state


def test_train_loop_matches_reference():
    _train_loop_matches("granite3_2b")


def test_mamba_train_loop_matches_reference():
    _train_loop_matches("mamba2_370m")


def test_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    args = ["--arch", "granite3_2b", "--smoke", "--batch", "4", "--seq", "16",
            "--ckpt", str(tmp_path), "--device", "cpu", "--checkpoint-every", "2"]
    # 4 steps, a checkpoint every 2: the loop saves step 4 itself, where
    # the reference's launcher saves it a second time and fails (ROADMAP C8)
    state = main(args + ["--steps", "4"])
    assert int(state.opt["step"]) == 4
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2, 4]
    state = main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 4" in out and "done at step 5" in out
    assert int(state.opt["step"]) == 5 and mgr.all_steps() == [2, 4, 5]


def test_launcher_trains_mamba_on_the_cpu(tmp_path, capsys):
    """``--arch mamba2_370m --smoke``: trains, checkpoints, and resumes."""
    from repro_torch.launch.train import main

    args = ["--arch", "mamba2_370m", "--smoke", "--batch", "2", "--seq", "80",
            "--ckpt", str(tmp_path), "--device", "cpu", "--checkpoint-every", "2"]
    state = main(args + ["--steps", "2"])
    assert int(state.opt["step"]) == 2
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))
    state = main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 2" in out and "done at step 3" in out
    assert int(state.opt["step"]) == 3


def test_training_raises_outside_the_slice():
    mamba = build_model(tconfigs.smoke_config_for("mamba2_370m"), "cpu")
    from repro_torch.models import model_zoo

    with pytest.raises(NotImplementedError, match="A16.3"):
        model_zoo.input_specs(mamba.cfg, "train_4k")
    with pytest.raises(NotImplementedError, match="A16.3"):
        mamba.init_shapes()


def test_init_state_draws_float32_masters_and_zero_moments():
    cfg = tconfigs.smoke_config_for("granite3_2b")
    model = build_model(cfg, "cpu")
    state = init_state(model, torch.Generator().manual_seed(5), TO.AdamWConfig(), compress=True)
    again = model.init_params(torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params), tree_leaves(again)))
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in tree_leaves(state.params))
    assert len(state.params["blocks"]) == cfg.n_repeats
    assert all(m.dtype == torch.bfloat16 and not m.any() for m in tree_leaves(state.opt["m"]))
    assert int(state.opt["step"]) == 0 and state.opt["step"].dtype == torch.int32
    assert all(e.dtype == torch.float32 and not e.any() for e in tree_leaves(state.ef_error))
    # the serving model's parameters are the same draw
    held = dict(model.init(torch.Generator().manual_seed(5)).named_parameters())
    assert torch.equal(held["params.embed"], again["embed"])
    assert torch.equal(held["params.blocks.1.layer0.mlp.w_up"],
                       again["blocks"][1]["layer0"]["mlp"]["w_up"])
