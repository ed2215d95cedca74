"""Correlated subqueries in the port's executor, each one
``torch.func.vmap`` of the subplan over the outer rows, against the
reference (its ``jax.vmap``), on the CPU.

* The decorrelation oracle (``conformance_util.check_decorrelation_oracle``)
  on the port: every kind and key shape, the five aggregates for ``agg``,
  an empty and a 23-row ``facts``, ``minq`` 0, 4 and 9.  The port's FROID
  and its per-row plan (the decorrelation rules off) each equal the
  reference's per-row answer (``_per_row_reference``) and its FROID; the
  port's INTERPRETED and HEKATON equal its FROID.  The oracle's
  ``execute_many`` and sharded legs wait for the port's ``execute_many``
  (ROADMAP A6).
* ``_exec_vmap_apply`` (semi, anti, cross, outer; ``passthrough`` set or
  not, which this path ignores in both packages), the correlated EXISTS,
  a GroupAgg under vmap on the sort, dense and relagg paths with
  ``pallas_agg`` on and off, a two-level nested correlated subquery with a
  GroupAgg, zero outer rows and an empty inner table, against the
  reference's executor.  With ``pallas_agg`` on, relagg's batched plain
  version runs and its unbatched one never does.
* relagg's batched plain version against the reference's ``jax.vmap`` of
  ``grouped_aggregate`` (Pallas in interpret mode) and against B
  unbatched calls.
* No functorch per-example fallback: every port run here holds the
  fallback warning as an error.

Counts, keys, masks and validity match exactly; floats to rtol 1e-4 with
an atol of 1e-4 (float32 sums of up to 23 values of |v| <= 10 differ by
~1e-5 between summation orders, and a sum may cancel to near 0).
"""
import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
from repro.core import relalg as RR
from repro.core import scalar as RS
from repro.core.executor import Executor as RefExecutor
from repro.kernels.relagg.ops import grouped_aggregate as ref_grouped_aggregate
import repro_torch.core as PC
from repro_torch.core import optimizer as PO
from repro_torch.core import relalg as PR
from repro_torch.core import scalar as PS
from repro_torch.core.session import _param_value
from repro_torch.kernels.relagg import ops as relagg_ops
from repro_torch.kernels.relagg.ref import (
    grouped_aggregate_batched_ref,
    grouped_aggregate_ref,
)

from conformance_util import (
    DECORR_AGGS,
    DECORR_KEYSHAPES,
    DECORR_KINDS,
    _per_row_reference,
    decorr_query,
    facts_data,
    make_session,
)
from test_torch_session_tpch import _norm_explain

RTOL = ATOL = 1e-4
PARAMS = [{"minq": 0}, {"minq": 4}, {"minq": 9}]


@contextlib.contextmanager
def no_vmap_fallback():
    """functorch's per-example fallback (an op without a batching rule run
    as a Python loop over the batch) raises inside the block."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_fallback_check_catches_a_fallback():
    with pytest.raises(UserWarning, match="batching rule"):
        with no_vmap_fallback():
            torch.func.vmap(lambda x: torch.histc(x, bins=4))(torch.ones((2, 3)))


def _host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_masked(expected, got, label):
    """Two MaskedTables (either package) equal: masks exactly; on surviving
    rows validity exactly, and values where valid (floats to RTOL/ATOL,
    the rest exactly)."""
    em, gm = _host(expected.mask), _host(got.mask)
    np.testing.assert_array_equal(gm, em, err_msg=f"{label}: mask")
    assert sorted(expected.table.columns) == sorted(got.table.columns), label
    for name, ec in expected.table.columns.items():
        gc = got.table.columns[name]
        ev, gv = _host(ec.validity()), _host(gc.validity())
        np.testing.assert_array_equal(gv[em], ev[em], err_msg=f"{label}: valid({name})")
        live = em & ev
        ed, gd = _host(ec.data), _host(gc.data)
        if ed.dtype.kind == "f":
            np.testing.assert_allclose(gd[live], ed[live], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{label}: {name}")
        else:
            np.testing.assert_array_equal(gd[live], ed[live], err_msg=f"{label}: {name}")
        if ec.dictionary is not None:
            assert list(gc.dictionary.vocab) == list(ec.dictionary.vocab), label


# ---------------------------------------------------------------------------
# the decorrelation oracle on the port
# ---------------------------------------------------------------------------


def _decorr(M, S, kind, keyshape, agg="sum"):
    """``conformance_util.decorr_query`` built with either package."""
    outer = M.scan("keys")
    if keyshape == "direct":
        pred = M.col("fk") == S.Outer("k")
    elif keyshape == "expr":
        pred = M.col("fk") == S.Outer("k") + M.lit(3)
    elif keyshape == "multi":
        outer = outer.compute(kk=M.col("k") + M.lit(1))
        pred = (M.col("fk") == S.Outer("k")) & (M.col("qty") == S.Outer("kk"))
    else:
        pred = M.col("fk") <= S.Outer("k")
    inner = M.scan("facts").filter(pred & (M.col("qty") >= M.param("minq")))
    if kind == "agg":
        body = inner.agg(s=getattr(M, agg + "_")(M.col("val")))
        return outer.compute(out=M.scalar_subquery(body, "s")).project("k", "out")
    if kind in ("exists", "not_exists"):
        return outer.compute(out=getattr(M, kind)(inner)).project("k", "out")
    test = M.exists if kind == "semi" else M.not_exists
    return outer.filter(test(inner)).compute(out=M.col("k") * 2.0).project("k", "out")


def _port_session(seed, n_rows, keys=None):
    port = PC.Session(device="cpu")
    port.create_table("facts", **facts_data(seed, n_rows))
    port.create_table("keys", k=np.arange(7) if keys is None else keys)
    return port


def _port_per_row(session, q, params):
    """The port's per-row plan: the decorrelation rules off, as
    ``conformance_util._per_row_reference`` plans the reference's."""
    wanted = PR.output_columns(q.node, session.catalog)
    rules = tuple(r for r in PO.DEFAULT_RULES
                  if r not in (PO.decorrelate_in_computes, PO.decorrelate_filters))
    plan = PO.optimize(q.node, session.catalog, required=set(wanted), rules=rules)
    if PR.output_columns(plan, session.catalog) != wanted:
        plan = PR.Project(plan, wanted)
    pvals = {n: _param_value(v, "cpu") for n, v in params.items()}
    return PC.Executor(session.catalog, device="cpu").execute(plan, params=pvals)


ORACLE = ([(kind, ks, "sum") for kind in DECORR_KINDS for ks in DECORR_KEYSHAPES]
          + [("agg", ks, agg) for ks in DECORR_KEYSHAPES for agg in DECORR_AGGS
             if agg != "sum"])


@pytest.mark.parametrize("n_rows", [23, 0], ids=["data", "empty"])
@pytest.mark.parametrize("spec", ORACLE, ids=["-".join(s) for s in ORACLE])
def test_decorrelation_oracle_on_the_port(spec, n_rows):
    kind, keyshape, agg = spec
    ref = make_session(1, n_rows)
    port = _port_session(1, n_rows)
    rq, pq = decorr_query(kind, keyshape, agg), _decorr(PC, PS, kind, keyshape, agg)
    rstmt, pstmt = ref.prepare(rq, RC.FROID), port.prepare(pq, PC.FROID)
    # the twin is the same statement: the same FROID plan
    assert _norm_explain(pstmt.explain()) == _norm_explain(rstmt.explain())
    # the reference's decorrelated semi/anti join crashes on an empty build
    # side (ROADMAP C1); its per-row answer stands for it there
    ref_froid = not (n_rows == 0 and kind in ("semi", "anti") and keyshape != "nonequi")
    iterative = [port.prepare(pq, p) for p in (PC.INTERPRETED, PC.HEKATON)]
    for i, p in enumerate(PARAMS):
        per_row = _per_row_reference(ref, rq, p).masked
        with no_vmap_fallback():
            froid = pstmt.execute(params=p).masked
            mine = _port_per_row(port, pq, p)
            others = [s.execute(params=p).masked for s in iterative]
        assert_masked(per_row, froid, f"[{i}] port FROID vs reference per-row")
        assert_masked(per_row, mine, f"[{i}] port per-row vs reference per-row")
        if ref_froid:
            assert_masked(rstmt.execute(params=p).masked, froid,
                          f"[{i}] port FROID vs reference FROID")
        for policy, got in zip(("interpreted", "hekaton"), others):
            assert_masked(froid, got, f"[{i}] port {policy} vs port FROID")


# ---------------------------------------------------------------------------
# the executor's correlated operators against the reference's
# ---------------------------------------------------------------------------

CATS = np.array(["red", "green", "blue"])


def _tables(n_facts=23, n_keys=7, seed=3):
    rng = np.random.default_rng(seed)
    facts = facts_data(seed, n_facts)
    facts["cat"] = CATS[rng.integers(0, 3, n_facts)]
    return {"facts": facts, "keys": {"k": np.arange(n_keys) - 1}}


def _catalogs(**kw):
    ref, port = RC.Session(), PC.Session(device="cpu")
    for name, arrays in _tables(**kw).items():
        ref.create_table(name, **arrays)
        port.create_table(name, **arrays)
    return ref.catalog, port.catalog


def _both(build, pallas=False, **kw):
    """``build(M, R, S)``'s plan run by the reference's executor and the
    port's (under :func:`no_vmap_fallback`); ``pallas`` is ``pallas_agg``
    for both, or a pair (the reference's, the port's)."""
    ref_pallas, port_pallas = pallas if isinstance(pallas, tuple) else (pallas, pallas)
    rcat, pcat = _catalogs(**kw)
    want = RefExecutor(rcat, use_pallas_agg=ref_pallas).execute(build(RC, RR, RS))
    with no_vmap_fallback():
        got = PC.Executor(pcat, use_pallas_agg=port_pallas, device="cpu").execute(
            build(PC, PR, PS))
    return want, got


def _apply(kind, passthrough):
    def build(M, R, S):
        right = (M.scan("facts").filter(M.col("fk") == S.Outer("k"))
                 .compute(w=M.col("val") * 2.0).project("w", "cat", "qty").node)
        pt = M.col("k") > 3 if passthrough else None
        return R.Apply(M.scan("keys").node, right, kind=kind, passthrough=pt)
    return build


@pytest.mark.parametrize("passthrough", [False, True])
@pytest.mark.parametrize("kind", ["semi", "anti", "cross", "outer"])
def test_vmap_apply_matches_reference(kind, passthrough):
    want, got = _both(_apply(kind, passthrough))
    assert_masked(want, got, f"Apply[{kind}]")
    if kind in ("cross", "outer"):  # the captured dictionary reaches the column
        assert sorted(got.table.columns["cat"].dictionary.vocab) == sorted(CATS)


def _exists(negated):
    def build(M, R, S):
        inner = M.scan("facts").filter((M.col("fk") <= S.Outer("k")) & (M.col("qty") > 6))
        test = M.not_exists(inner) if negated else M.exists(inner)
        return M.scan("keys").compute(out=test).node
    return build


@pytest.mark.parametrize("negated", [False, True])
def test_correlated_exists_matches_reference(negated):
    want, got = _both(_exists(negated))
    assert_masked(want, got, "EXISTS")
    assert got.table.columns["out"].data.dtype == torch.bool


#: grouped bodies: (key, capacity, dense range, aggregates), relagg-able
#: (sum, avg, count, count(*)) or not (min, max)
GROUPED = {
    "sort": ("qty", None, None, "relagg"),
    "sort_minmax": ("qty", None, None, "minmax"),
    "capacity": ("qty", 9, None, "relagg"),
    "dense": ("qty", 9, (0, 8), "relagg"),
    "dense_minmax": ("qty", 9, (0, 8), "minmax"),
    "dictionary": ("cat", None, None, "relagg"),
}


def _grouped(name, pred=None):
    key, cap, dense, aggs = GROUPED[name]

    def build(M, R, S):
        cond = M.col("fk") <= S.Outer("k") if pred is None else pred(M, S)
        inner = M.scan("facts").filter(cond)
        if aggs == "relagg":
            g = inner.group_by(key, capacity=cap, a=M.sum_(M.col("val")),
                               b=M.avg_(M.col("val")), c=M.count_(M.col("val")),
                               d=M.count_()).node
        else:
            g = inner.group_by(key, capacity=cap, a=M.min_(M.col("val")),
                               b=M.max_(M.col("val")), c=M.count_(M.col("val")),
                               d=M.count_()).node
        if dense is not None:
            g = R.GroupAgg(g.child, g.keys, dict(g.aggs), g.capacity, dense)
        sub = lambda col, agg: M.scalar_subquery(  # noqa: E731
            R.GroupAgg(g, [], {"x": R.AggSpec(agg, S.ColRef(col))}), "x")
        return M.scan("keys").compute(
            a=sub("a", "max"), b=sub("b", "min"), c=sub("c", "sum"), d=sub("d", "max"),
            key=sub(key, "count")).node
    return build


@contextlib.contextmanager
def relagg_calls():
    """The calls of relagg's plain versions inside the block: unbatched
    and batched."""
    calls = {"unbatched": 0, "batched": 0}
    plain, batched = relagg_ops.grouped_aggregate_ref, relagg_ops.grouped_aggregate_batched_ref

    def one(*a):
        calls["unbatched"] += 1
        return plain(*a)

    def many(*a):
        calls["batched"] += 1
        return batched(*a)

    relagg_ops.grouped_aggregate_ref = one
    relagg_ops.grouped_aggregate_batched_ref = many
    try:
        yield calls
    finally:
        relagg_ops.grouped_aggregate_ref = plain
        relagg_ops.grouped_aggregate_batched_ref = batched


@pytest.mark.parametrize("pallas", [False, True], ids=["relagg_off", "relagg_on"])
@pytest.mark.parametrize("name", list(GROUPED))
def test_groupagg_under_vmap_matches_reference(name, pallas):
    with relagg_calls() as calls:
        want, got = _both(_grouped(name), pallas)
    assert_masked(want, got, f"GroupAgg {name}")
    relagg = pallas and GROUPED[name][3] == "relagg" and (
        GROUPED[name][1] is not None or name == "dictionary")
    # five subqueries, one batched relagg call each where relagg applies
    assert calls == {"unbatched": 0, "batched": 5 if relagg else 0}


@pytest.mark.parametrize("pallas", [False, True], ids=["relagg_off", "relagg_on"])
def test_nested_correlated_groupagg_matches_reference(pallas):
    """A correlated subquery inside a correlated subquery: the inner one's
    GroupAgg runs under two vmap levels (relagg's rule folds them)."""
    def build(M, R, S):
        inner = (M.scan("facts")
                 .filter((M.col("fk") == S.Outer("qty")) & (M.col("qty") <= S.Outer("k")))
                 .group_by("qty", capacity=9, s=M.sum_(M.col("val")), n=M.count_())
                 .agg(m=M.max_(M.col("s"))))
        middle = (M.scan("facts").filter(M.col("fk") <= S.Outer("k"))
                  .compute(w=M.scalar_subquery(inner, "m"))
                  .agg(t=M.sum_(M.col("w")), c=M.count_(M.col("w"))))
        return M.scan("keys").compute(out=M.scalar_subquery(middle, "t")).node

    with relagg_calls() as calls:
        want, got = _both(build, pallas)
    assert_masked(want, got, "nested")
    assert calls == {"unbatched": 0, "batched": 1 if pallas else 0}


SHAPES = {
    "groupagg": _grouped("capacity"),
    "full_agg": lambda M, R, S: M.scan("keys").compute(out=M.scalar_subquery(
        M.scan("facts").filter(M.col("fk") <= S.Outer("k")).agg(s=M.sum_(M.col("val"))),
        "s")).node,
    "exists": _exists(False),
    "apply": _apply("outer", False),
}


@pytest.mark.parametrize("n_keys,n_facts", [(0, 23), (7, 0), (0, 0)],
                         ids=["no_outer_rows", "empty_inner", "both_empty"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_empty_outer_or_inner_matches_reference(shape, n_keys, n_facts):
    """Where the reference raises (ROADMAP C4), the per-row answer stands
    for it: an Apply over an empty right side (its ``jnp.argmax`` of an
    empty mask) keeps every left row with NULL right columns, and relagg
    over zero outer rows (Pallas in interpret mode under ``jax.vmap`` of
    size 0) gives what the reference's other group-by path gives."""
    for pallas in (False, True):
        label = f"{shape} keys={n_keys} facts={n_facts} pallas_agg={pallas}"
        if shape == "apply" and n_facts == 0:
            _, pcat = _catalogs(n_keys=n_keys, n_facts=n_facts)
            with no_vmap_fallback():
                got = PC.Executor(pcat, use_pallas_agg=pallas, device="cpu").execute(
                    SHAPES[shape](PC, PR, PS))
            assert got.mask.numpy().all() and got.num_rows == n_keys, label
            np.testing.assert_array_equal(got.table.columns["k"].data.numpy(),
                                          np.arange(n_keys) - 1)
            for c in ("w", "cat", "qty"):
                assert not got.table.columns[c].validity().numpy().any(), label
            continue
        ref_pallas = pallas and not (shape == "groupagg" and n_keys == 0)
        want, got = _both(SHAPES[shape], (ref_pallas, pallas), n_keys=n_keys,
                          n_facts=n_facts)
        assert_masked(want, got, label)
        assert got.num_rows == n_keys


# ---------------------------------------------------------------------------
# relagg's batched plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", ["mask", "all"])
@pytest.mark.parametrize("B,n,groups,n_aggs", [(1, 64, 1, 1), (4, 257, 8, 3),
                                               (7, 1000, 130, 2), (3, 0, 5, 1)])
def test_batched_plain_relagg_matches_pallas_vmap_and_unbatched(rng, B, n, groups,
                                                                n_aggs, batched):
    gid = rng.integers(-2, groups + 2, (B, n) if batched == "all" else n).astype(np.int32)
    mask = rng.random((B, n)) > 0.4
    vals = rng.normal(size=((B, n, n_aggs) if batched == "all" else (n, n_aggs))
                      ).astype(np.float32)
    axes = (0 if batched == "all" else None, 0, 0 if batched == "all" else None)
    if n:
        rs, rc = jax.vmap(lambda g, m, v: ref_grouped_aggregate(g, m, v, groups, 256, True),
                          in_axes=axes)(jnp.asarray(gid), jnp.asarray(mask), jnp.asarray(vals))
    tg, tm, tv = (torch.as_tensor(a) for a in (gid, mask, vals))
    if batched == "mask":
        tg, tv = tg.expand(B, n), tv.expand(B, n, n_aggs)
    s, c = grouped_aggregate_batched_ref(tg, tm, tv, groups)
    assert s.shape == (B, groups, n_aggs) and c.shape == (B, groups)
    if n:
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    for b in range(B):
        s1, c1 = grouped_aggregate_ref(tg[b], tm[b], tv[b], groups)
        np.testing.assert_array_equal(s[b].numpy(), s1.numpy())
        np.testing.assert_array_equal(c[b].numpy(), c1.numpy())


def test_relagg_wrapper_under_nested_vmap(rng):
    """Two vmap levels fold into one batched plain call, equal to the
    unbatched call of each (outer, inner) pair."""
    gid = torch.as_tensor(rng.integers(0, 4, 50).astype(np.int32))
    masks = torch.as_tensor(rng.random((3, 50)) > 0.5)
    vals = torch.as_tensor(rng.normal(size=(2, 50, 2)).astype(np.float32))
    with relagg_calls() as calls, no_vmap_fallback():
        s, c = torch.func.vmap(lambda v: torch.func.vmap(
            lambda m: relagg_ops.grouped_aggregate(gid, m, v, 4))(masks))(vals)
    assert calls == {"unbatched": 0, "batched": 1}
    assert s.shape == (2, 3, 4, 2) and c.shape == (2, 3, 4)
    for a in range(2):
        for b in range(3):
            s1, c1 = grouped_aggregate_ref(gid, masks[b], vals[a], 4)
            np.testing.assert_array_equal(s[a, b].numpy(), s1.numpy())
            np.testing.assert_array_equal(c[a, b].numpy(), c1.numpy())


# ---------------------------------------------------------------------------
# chip_smoke.py's correlated phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("spec", ORACLE, ids=["-".join(s) for s in ORACLE])
def test_smoke_decorr_query_is_the_harness_statement(smoke, spec):
    """The script's own copy of ``decorr_query`` plans as the harness's."""
    ref, port = make_session(1, 23), _port_session(1, 23)
    want = ref.prepare(decorr_query(*spec), RC.FROID).explain()
    got = port.prepare(smoke.decorr_query(*spec), PC.FROID).explain()
    assert _norm_explain(got) == _norm_explain(want)


@pytest.mark.parametrize("pallas", [False, True], ids=["relagg_off", "relagg_on"])
def test_smoke_correlated_queries_meet_their_float64_answers(smoke, pallas):
    """The SF-1 statements and their float64 answers, at SF 0.001 on the
    CPU: every statement keeps its per-row apply and passes the script's
    own check."""
    from repro_torch.data.tpch import generate_tpch

    s = PC.Session(device="cpu")
    generate_tpch(s, sf=0.001)
    odate = s.catalog["orders"].columns["o_orderdate"].data.numpy()
    pick = np.argsort(odate, kind="stable")[np.linspace(0, len(odate) - 1, 16).astype(int)]
    s.create_table("orders16", o_orderkey=pick, o_orderdate=odate[pick])
    expected = smoke.correlated_expected(s, odate[pick])
    assert expected["exists"].any() and not expected["exists"].all()
    policy = PC.ExecutionPolicy(name="froid+relagg", pallas_agg=pallas)
    for name, q in smoke.correlated_queries().items():
        stmt = s.prepare(q, policy)
        assert smoke.has_correlated_subquery(stmt.plan), name
        with no_vmap_fallback():
            smoke.check_correlated(stmt.execute().masked, name, expected, name)
