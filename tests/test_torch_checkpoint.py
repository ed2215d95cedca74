"""The port's ``CheckpointManager`` (``repro_torch.train.checkpoint``) on
the CPU: the reference's roundtrip, atomicity and corrupt-skip and keep-N
cases (``tests/test_train_runtime.py``), the on-disk format shared with
the reference in both directions (a checkpoint the reference writes is
restored by the port to an equal tree, and the other way round, bf16
moments included, bit for bit), and ``wait()`` re-raising a worker's
error."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config_for
from repro.models import build_model as ref_build
from repro.train.checkpoint import CheckpointManager as RefManager
from repro.train.optim import AdamWConfig as RefAdamW
from repro.train.train_loop import init_state as ref_init_state
from repro_torch import configs as tconfigs
from repro_torch.models import build_model
from repro_torch.models.convert import state_from_reference, tree_to_reference
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.train_loop import TrainState, init_state, train_loop
from repro_torch.data.pipeline import DataPipeline
from repro_torch.tree import tree_leaves


def _state(seed=0):
    cfg = tconfigs.smoke_config_for("granite3_2b")
    model = build_model(cfg, "cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    return model, opt_cfg, init_state(model, torch.Generator().manual_seed(seed), opt_cfg), cfg


def _equal_trees(a, b):
    """Equal structure (dict keys in any order, lists in order) and equal
    leaves: dtype, shape and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    model, opt_cfg, state, cfg = _state()
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_write=False)
    pipe = DataPipeline(batch=4, seq_len=32, vocab=cfg.vocab, seed=1, device="cpu")
    state = train_loop(model, state, iter(pipe), opt_cfg, steps=4,
                       checkpoint_mgr=mgr, checkpoint_every=2, log_every=0)
    assert mgr.latest_step() == 4
    step, restored = mgr.restore_latest()
    assert step == 4
    state2 = TrainState(restored["params"], restored["opt"], None)
    assert int(state2.opt["step"]) == 4 and state2.opt["step"].dtype == torch.int32
    _equal_trees(state2.params, state.params)
    _equal_trees(state2.opt, state.opt)
    assert isinstance(restored["params"]["blocks"], list)


def test_checkpoint_atomicity_and_corruption_skip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=5, async_write=False)
    tree = {"a": torch.arange(8.0), "b": {"c": torch.ones((2, 3))}}
    mgr.save(1, tree)
    mgr.save(2, tree)
    d = os.path.join(str(tmp_path), "step_00000002")
    shard = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, shard), "wb") as f:
        f.write(b"corrupt")
    step, restored = mgr.restore_latest()
    assert step == 1  # falls back to the newest verifiable checkpoint
    np.testing.assert_allclose(restored["a"].numpy(), np.arange(8.0))
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]


def test_checkpoint_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(4)})
    assert mgr.all_steps() == [3, 4]


def test_async_save_and_wait_reraises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(1, {"x": torch.arange(3)})
    mgr.wait()
    assert mgr.latest_step() == 1
    # a write that fails on the worker thread surfaces on wait()
    blocker = os.path.join(str(tmp_path), ".tmp-2-p0")
    with open(blocker, "w") as f:
        f.write("a file where the write wants a directory")
    mgr.save(2, {"x": torch.arange(3)})
    with pytest.raises(OSError):
        mgr.wait()
    assert mgr.latest_step() == 1
    mgr.wait()  # the error was raised once


def _ref_state():
    cfg = smoke_config_for("granite3_2b")
    model = ref_build(cfg)
    opt = RefAdamW(lr=1e-3, warmup_steps=2, total_steps=50)
    st = ref_init_state(model, jax.random.PRNGKey(3), opt)
    # bf16 moments that are not all zero
    m = jax.tree.map(lambda p: (p * 0.5).astype(jnp.bfloat16), st.params)
    v = jax.tree.map(lambda p: (p * p).astype(jnp.bfloat16), st.params)
    return {"params": st.params, "opt": {"m": m, "v": v, "step": jnp.asarray(7, jnp.int32)}}


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_reference_checkpoint_restores_on_the_port(tmp_path):
    tree = _ref_state()
    RefManager(str(tmp_path), async_write=False, process_index=0).save(7, tree)
    step, restored = CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 7
    want = state_from_reference(jax.tree.map(_np, tree), tconfigs.smoke_config_for(
        "granite3_2b"), "cpu")
    _equal_trees(restored["params"], want.params)
    _equal_trees(restored["opt"], want.opt)
    assert restored["opt"]["m"]["embed"].dtype == torch.bfloat16


def test_port_checkpoint_restores_on_the_reference(tmp_path):
    tree = _ref_state()
    cfg = tconfigs.smoke_config_for("granite3_2b")
    port = state_from_reference(jax.tree.map(_np, tree), cfg, "cpu")
    CheckpointManager(str(tmp_path), async_write=False).save(
        7, {"params": port.params, "opt": port.opt})
    manifest = json.load(open(tmp_path / "step_00000007" / "manifest.p0.json"))
    assert manifest["leaves"]["opt/m/blocks/layer0/attn/wq"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["params/blocks/layer0/attn/wq"]["shape"][0] == cfg.n_repeats
    step, restored = RefManager(str(tmp_path), process_index=0).restore_latest()
    assert step == 7
    got, want = jax.tree.leaves(jax.tree.map(_np, restored)), jax.tree.leaves(
        jax.tree.map(_np, tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.asarray(restored["opt"]["m"]["embed"]).dtype.name == "bfloat16"
    # the converter writes the same layout
    flat = jax.tree.leaves(tree_to_reference({"params": port.params, "opt": port.opt}))
    assert all(np.array_equal(a, b) for a, b in zip(flat, want))
