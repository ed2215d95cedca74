"""The port's sharded fused wave on a mesh with a ``pod`` axis, against the
reference (ROADMAP C9).

The reference pads a batched fused member only where
``pick_data_axes(mesh, bucket)`` is None and places each member by its
own ``batch_sharding(mesh, bucket)``: a bucket that divides ``data`` but
not ``pod x data`` is split over ``data`` alone, replicated over ``pod``
and left unpadded.  The port runs the same waves on a ``(2, 2, 2)``
``pod``/``data``/``model`` mesh over ``["cpu"] * 8``; the reference runs
them in one module-scoped subprocess under 8 forced host devices.  The
member buckets, the fused cache keys' member buckets, the ``fuse_*`` and
``shard_*`` counters and the per-result figures must be equal wave by
wave, and the rows equal the port's serial loop and the reference's.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import conformance_util as CU
import repro.core as RC
import repro_torch.core as PC
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.scheduler import CoalescingScheduler

from test_torch_correlated import assert_masked, no_vmap_fallback
from test_torch_fused import PCU, _udf_session

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (pod, data, model): 4 data-axis positions, 2 along ``data`` alone
MESH_SHAPE = (2, 2, 2)
MESH_AXES = ("pod", "data", "model")
N_DEVICES = 8

#: waves over ``conformance_util.fusion_queries()`` (two batched
#: statements and a parameter-free one).  Buckets: 8 splits over ``pod x
#: data``; 2 divides ``data`` but not ``pod x data`` (split over ``data``
#: alone, unpadded); 3 tickets bucket to 4 (``pod x data``); 1 divides
#: neither and pads to 4
WAVES = {
    "data_alone": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
                   + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(2)]
                   + [(2, None) for _ in range(2)]),
    "data_alone_only": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(2)]
                        + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(2)]),
    "mixed": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
              + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(3)]
              + [(2, None) for _ in range(2)]),
    "padded_one": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(2)]
                   + [(1, {"minq": 3, "scale": 2.0})]),
}

COUNTERS = ("fuse_hits", "fuse_misses", "shard_hits", "shard_misses")


@pytest.fixture(autouse=True)
def _no_fallback():
    with no_vmap_fallback():
        yield


def port_mesh():
    return make_mesh(MESH_SHAPE, MESH_AXES, ["cpu"] * N_DEVICES)


def _session(M, seed):
    if M is PC:
        return _udf_session(seed, 23, PCU)
    db = CU.make_session(seed, 23)
    db.create_function(CU.build_udf(CU.FIXED_PROGRAMS["uncorrelated_sum_case"]).build())
    return db


def _scheduler(M):
    if M is PC:
        return CoalescingScheduler(max_batch=256, window_s=10.0, clock=lambda: 0.0,
                                   fuse=True)
    from repro.serve.scheduler import CoalescingScheduler as RefScheduler

    return RefScheduler(max_batch=256, window_s=10.0, clock=lambda: 0.0, fuse=True)


def _fig(results) -> list:
    return [[r.stats.get("batch_size"), r.stats.get("batch_bucket"),
             bool(r.stats.get("sharded", False)), r.stats.get("shard_devices"),
             bool(r.stats.get("fused", False))] for r in results]


def run_wave(M, mesh, name: str, seed: int = 31) -> tuple[list, list]:
    """The wave ``name`` drained twice (cold, then a fuse hit) through a
    fusion scheduler over a sharded FROID policy: (figures, results of
    both drains)."""
    db = _session(M, seed)
    qs = CU.fusion_queries() if M is RC else PCU.fusion_queries()
    stmts = [db.prepare(q, M.FROID.sharded(mesh)) for q in qs]
    figs, results = [], []
    for _ in range(2):
        sched = _scheduler(M)
        tickets = [sched.submit(stmts[i], p) for i, p in WAVES[name]]
        sched.flush()
        rs = [t.result() for t in tickets]
        results += rs
        figs.append([_fig(rs), {k: db.cache_stats[k] for k in COUNTERS}])
    # each fused program's member buckets, as its cache key carries them
    # (the key's fingerprints and stamps are each package's own)
    keys = sorted([[m[2] for m in key[0]], bool(key[4])] for key in db._fuse_execs)
    return [figs, keys], results


def figures(M, mesh) -> dict:
    return {name: json.loads(json.dumps(run_wave(M, mesh, name)[0])) for name in WAVES}


def reference_figures() -> dict:
    """:func:`figures` on ``repro`` over the forced host devices."""
    import jax

    assert len(jax.devices()) == N_DEVICES, jax.devices()
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(MESH_SHAPE), MESH_AXES)
    return figures(RC, mesh)


@pytest.fixture(scope="module")
def ref_figures():
    code = ("import json, test_torch_sharded_pod as T\n"
            "print('FIGURES ' + json.dumps(T.reference_figures()))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={N_DEVICES}",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("FIGURES "))
    return json.loads(line[len("FIGURES "):])


@pytest.mark.parametrize("name", sorted(WAVES))
def test_pod_mesh_figures_equal_the_reference(name, ref_figures):
    """Buckets, fused cache keys, ``fuse_*``/``shard_*`` counters and the
    per-result figures on the ``(2, 2, 2)`` mesh equal the reference's."""
    got, results = run_wave(PC, port_mesh(), name)
    assert json.loads(json.dumps(got)) == ref_figures[name]
    assert all(r.stats.get("fused") and r.stats.get("sharded") for r in results)


def test_reference_splits_a_data_alone_bucket(ref_figures):
    """The reference really leaves a bucket of 2 unpadded on this mesh: the
    2-ticket member's bucket is 2, not the 4 of ``pod x data``."""
    figs, keys = ref_figures["data_alone"]
    first_drain = figs[0][0]
    assert first_drain[8] == [2, 2, True, 4, True]
    assert len(keys) == 1 and sorted(keys[0][0]) == [1, 2, 8] and keys[0][1]


@pytest.mark.parametrize("name", sorted(WAVES))
def test_pod_mesh_rows_equal_serial_and_reference(name):
    """Every ticket of both drains equals the port's serial loop and the
    reference's fused drain on one device."""
    _, results = run_wave(PC, port_mesh(), name)
    db = _session(PC, 31)
    stmts = [db.prepare(q, PC.FROID) for q in PCU.fusion_queries()]
    serial = [stmts[i].execute(params=p) for i, p in WAVES[name]] * 2
    for j, (s, f) in enumerate(zip(serial, results)):
        assert_masked(s.masked, f.masked, f"{name}[{j}] vs serial")
    ref_db = _session(RC, 31)
    rstmts = [ref_db.prepare(q, RC.FROID) for q in CU.fusion_queries()]
    want = [rstmts[i].execute(params=p) for i, p in WAVES[name]] * 2
    for j, (w, f) in enumerate(zip(want, results)):
        assert_masked(w.masked, f.masked, f"{name}[{j}] vs reference")
