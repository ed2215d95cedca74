"""The port's serving path (``repro_torch.serve``) against the reference's
(``repro.serve``) on the CPU.

* Admission: the Froid-compiled rules evaluated by the port's ``Session``
  give the reference's verdicts exactly, at the rules' edges.
* Engine: with the reference's parameters carried across, greedy tokens
  equal the reference's up to the first step where the reference's own
  top-1/top-2 logit margin is below the bf16 tolerance (2e-2 x max|logit|
  of that step); from there on bf16 rounding may pick either token.
  ``jax.random.categorical`` and the port's sampler draw other tokens from
  one seed, so temperature paths are checked for reproducibility and valid
  ids only.
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config_for
from repro.models import build_model as ref_build
from repro.serve.admission import AdmissionPolicy as RefAdmission
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
import repro_torch.core as PC
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import AdmissionPolicy, Request, ServeEngine


def _edge_requests(n: int, rng) -> dict:
    """n queued requests (queue depth n) cycling through the rules' edges."""
    plen = np.array([2048, 2049, 8192, 8193, 32768, 32769, 1, 5000])
    temp = np.array([-0.1, 2.1, 0.0, 0.7, 1.0, 1.5, 2.0, 0.5, 1.2, 3.0], np.float32)
    i = np.arange(n)
    return {"tier": i % 3, "prompt_len": plen[i % len(plen)],
            "max_new_tokens": rng.integers(1, 5000, n),
            "temperature": temp[i % len(temp)]}


@pytest.mark.parametrize("depth", [9, 512, 513])
def test_admission_matches_reference(rng, depth):
    """Queue depth 512 admits an 8193-token prompt, 513 sheds it."""
    reqs = _edge_requests(depth, rng)
    got = AdmissionPolicy(device="cpu").evaluate(reqs)
    want = RefAdmission().evaluate(reqs)
    for name in ("admit", "granted", "temp"):
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    shed = reqs["prompt_len"] == 8193
    assert got["admit"][shed].all() == (depth <= 512)
    assert not got["admit"][reqs["prompt_len"] == 32769].any()


class _Recording:
    """The reference model, recording the logits of every prefill and
    decode step in order (a test-side proxy; nothing of the reference
    changes)."""

    def __init__(self, model):
        self.model, self.logits = model, []
        self._decode = jax.jit(model.decode_step)

    def prefill(self, params, tokens, max_len=None):
        logits, cache = self.model.prefill(params, tokens, max_len=max_len)
        self.logits.append(np.asarray(logits))
        return logits, cache

    def decode_step(self, params, cache, tokens):
        logits, cache = self._decode(params, cache, tokens)
        self.logits.append(np.asarray(logits))
        return logits, cache


def _requests(cls, rng, vocab, temps):
    lens = [9, 14, 6, 11, 12]
    reqs = [cls(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=6, temperature=t, tier=1)
            for i, (n, t) in enumerate(zip(lens, temps))]
    reqs.append(cls(rid=len(lens), prompt=np.zeros(33_000, np.int32), max_new_tokens=6,
                    temperature=0.0, tier=1))  # over 32768: rejected before prefill
    return reqs


@pytest.mark.parametrize("arch", ["granite3_2b", "mamba2_370m"])
def test_engine_greedy_tokens_match_reference(arch):
    ref_cfg = smoke_config_for(arch)
    model = ref_build(ref_cfg)
    params = model.init(jax.random.PRNGKey(0))
    port = params_from_reference(jax.tree.map(np.asarray, params),
                                 tconfigs.smoke_config_for(arch), "cpu")
    temps = [0.0] * 5
    rec = _Recording(model)
    ref_eng = RefEngine(rec, params, slots=4, max_len=64)
    ref_eng._decode = rec.decode_step  # record each step
    ref_done = {c.rid: c for c in ref_eng.run(
        _requests(RefRequest, np.random.default_rng(0), ref_cfg.vocab, temps))}
    done = {c.rid: c for c in ServeEngine(port, slots=4, max_len=64).run(
        _requests(Request, np.random.default_rng(0), ref_cfg.vocab, temps))}
    assert done[5].reason == ref_done[5].reason == "rejected" and not done[5].tokens

    # step logits per batch: batch 0 holds requests 0-3, batch 1 request 4
    steps = {0: rec.logits[:6], 1: rec.logits[6:12]}
    compared = 0
    for rid in range(5):
        batch, row = divmod(rid, 4)
        want, got = ref_done[rid].tokens, done[rid].tokens
        assert done[rid].reason == ref_done[rid].reason == "length"
        assert len(got) == len(want) == 6
        for j, logits in enumerate(steps[batch]):
            top2 = np.sort(logits[row])[-2:]
            if top2[1] - top2[0] < 2e-2 * np.abs(logits).max():
                break
            assert got[j] == want[j], (rid, j)
            compared += 1
    assert compared >= 10


def test_engine_sampling_is_reproducible():
    cfg = tconfigs.smoke_config_for("granite3_2b")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    temps = [0.7, 1.0, 0.0, 0.7, 1.0]
    runs = [ServeEngine(model, slots=4, max_len=64, seed=7).run(
        _requests(Request, np.random.default_rng(1), cfg.vocab, temps)) for _ in range(2)]
    a, b = ({c.rid: c.tokens for c in run} for run in runs)
    assert a == b
    assert all(0 <= t < cfg.vocab for toks in a.values() for t in toks)
    assert a[5] == [] and all(len(a[i]) == 6 for i in range(5))


def test_unported_intake_raises():
    """The online intake itself is ported (ROADMAP A6; held to ``run`` in
    ``tests/test_torch_execute_many.py``), and so are its fused drains
    (A7): ``fuse`` passes through to the scheduler, as in
    ``tests/test_fused.py:459-488``, and coalesced verdicts equal the
    tick's.  So is its mesh (A10): ``mesh`` shards the request statement,
    whose coalesced verdicts equal the tick's too, and whose sharded
    router keys carry the shard token in the reference's position.  The
    store is ported (``test_admission_store_warm_start``)."""
    cfg = tconfigs.smoke_config_for("granite3_2b")
    model = build_model(cfg, "cpu").init()
    eng = ServeEngine(model, slots=2, max_len=32, admission_fuse=True,
                      admission_adaptive=True)
    assert eng.admission.scheduler.fuse and eng.admission.scheduler.adaptive
    ap = AdmissionPolicy(device="cpu", fuse=True)
    assert ap.scheduler.fuse
    reqs = _edge_requests(9, np.random.default_rng(0))
    tick, co = ap.evaluate(reqs), ap.evaluate_coalesced(reqs)
    for name in ("admit", "granted", "temp"):
        np.testing.assert_array_equal(co[name], tick[name], err_msg=name)
    mesh = make_small_mesh(data=4, devices=["cpu"] * 4)
    sharded = AdmissionPolicy(device="cpu", mesh=mesh, policy=PC.ROUTED)
    co = sharded.evaluate_coalesced(_edge_requests(8, np.random.default_rng(0)))
    want = ap.evaluate(_edge_requests(8, np.random.default_rng(0)))
    for name in ("admit", "granted", "temp"):
        np.testing.assert_array_equal(co[name], want[name], err_msg=name)
    stmt = sharded.request_statement()
    assert stmt.policy.mesh is mesh and stmt.policy.shard_devices() == 4
    keys = [k for k in sharded._request_session.cost_router.measured if k[0] == "many"]
    assert keys and all(k[4] == stmt.policy.shard_token() for k in keys)


def test_admission_store_warm_start(tmp_path):
    """``tests/test_fleet.py::test_admission_store_warm_start`` on the port:
    a second policy over the first one's store serves the request
    statement from it, with the cold verdicts (and the reference's); the
    tick session and the request session share one store, and the
    engine's ``admission_store`` reaches it."""
    reqs = dict(
        tier=np.array([0, 1, 2]),
        prompt_len=np.array([10, 100, 3000]),
        max_new_tokens=np.array([50, 2000, 500]),
        temperature=np.array([0.5, 3.0, 0.9], dtype="float32"),
    )
    cold = AdmissionPolicy(device="cpu", store=str(tmp_path))
    assert cold._request_session.store is cold.session.store
    v_cold = cold.evaluate_coalesced(reqs)
    assert cold._request_session.persist_stats["saves"] >= 1

    warm = AdmissionPolicy(device="cpu", store=str(tmp_path))
    v_warm = warm.evaluate_coalesced(reqs)
    assert warm._request_session.cache_stats["persist_hits"] >= 1
    assert warm._request_session.persist_stats["saves"] == 0
    want = RefAdmission(store=str(tmp_path / "ref")).evaluate_coalesced(reqs)
    for k in v_cold:
        assert (v_cold[k] == v_warm[k]).all(), k
        np.testing.assert_array_equal(v_warm[k], want[k], err_msg=k)
    eng = ServeEngine(build_model(tconfigs.smoke_config_for("granite3_2b"), "cpu").init(),
                      slots=2, max_len=32, admission_store=str(tmp_path))
    assert eng.admission.session.store.root == tmp_path


def test_interpreted_admission_raises():
    """``froid=False`` (INTERPRETED, the per-row interpreter) now gives the
    reference's verdicts."""
    reqs = _edge_requests(9, np.random.default_rng(0))
    got = AdmissionPolicy(froid=False, device="cpu").evaluate(reqs)
    want = RefAdmission(froid=False).evaluate(reqs)
    for name in ("admit", "granted", "temp"):
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("policy", ["interpreted", "hekaton"])
@pytest.mark.parametrize("depth", [9, 513])
def test_iterative_admission_matches_froid(depth, policy):
    """The rules interpreted per request give FROID's verdicts, at the
    rules' edges (queue depth 513 sheds an 8193-token prompt)."""
    reqs = _edge_requests(depth, np.random.default_rng(depth))
    froid = AdmissionPolicy(device="cpu").evaluate(reqs)
    got = AdmissionPolicy(policy=policy, device="cpu").evaluate(reqs)
    for name in ("admit", "granted", "temp"):
        assert got[name].dtype == froid[name].dtype
        np.testing.assert_array_equal(got[name], froid[name], err_msg=name)


def test_launcher_hekaton_admission_on_the_cpu(capsys):
    done = launcher.main(["--arch", "granite3_2b", "--smoke", "--device", "cpu",
                          "--requests", "3", "--max-new", "2", "--admission", "hekaton"])
    assert len(done) == 3 and all(len(c.tokens) == 2 for c in done)
    assert "req 2: 2 tokens (length)" in capsys.readouterr().out


def test_launcher_runs_on_the_cpu(capsys):
    done = launcher.main(["--arch", "mamba2_370m", "--smoke", "--device", "cpu",
                          "--requests", "3", "--max-new", "3"])
    assert len(done) == 3 and all(len(c.tokens) == 3 for c in done)
    assert "req 2: 3 tokens (length)" in capsys.readouterr().out


def test_serving_imports_leave_jax_and_repro_unloaded():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.models.convert\n"
        "import repro_torch.kernels.flash_attention.flash_attention\n"
        "import repro_torch.kernels.ssd_scan.ssd_scan\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "sys.exit(1 if loaded else 0)\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
