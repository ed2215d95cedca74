"""The port's ``Executor`` against the reference's, operator by operator.

Each query is built twice, once with each package's frontend, and planned
by each package's own optimizer over the same numpy tables; the two
``explain()`` texts must be equal (object addresses of IR nodes without a
``repr`` aside).  Then both executors run their plan: masks and validity
must match exactly, ints exactly, floats to rtol/atol 1e-5 (segment sums
add in another order).  Every query also runs over an empty ``facts``.

The empty-build semi/anti join, where the reference raises (ROADMAP C1),
is held to the per-row answer instead (``tests/conformance_util.py``'s
``_per_row_reference``)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
from repro.core import optimizer as RO
from repro.core import relalg as RR
from repro.core import scalar as RS
from repro.tables import table as RT
import repro_torch.core as PC
from repro_torch.core import optimizer as PO
from repro_torch.core import relalg as PR
from repro_torch.core import scalar as PS
from repro_torch.tables import table as PT

from conformance_util import _per_row_reference, decorr_query, make_session

CATS = ("red", "green", "blue")


def _host(n: int, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2
    cat_valid = rng.random(n) > 0.1
    return {
        "facts": {
            "fk": (rng.integers(0, 7, n).astype(np.int32), None, None),
            "k2": (rng.integers(0, 3, n).astype(np.int32), None, None),
            "val": (np.round(rng.uniform(-10, 10, n), 2).astype(np.float32), valid, None),
            "qty": (rng.integers(0, 9, n).astype(np.int32), None, None),
            "cat": (rng.integers(0, 3, n).astype(np.int32), cat_valid, CATS),
        },
        "dims": {
            "dk": (np.arange(3, 13, dtype=np.int32), None, None),
            "dname": (np.arange(10, dtype=np.int32) % 4, None,
                      ("d0", "d1", "d2", "d3")),
            "dval": (np.linspace(0.5, 5.0, 10).astype(np.float32), None, None),
        },
        "pairs": {
            "a": (np.repeat(np.arange(2, 6, dtype=np.int32), 2), None, None),
            "b": (np.tile(np.arange(2, dtype=np.int32), 4), None, None),
            "plabel": (np.arange(8, dtype=np.float32) * 1.5, None, None),
        },
    }


def _ref_catalog(host):
    cat = {
        t: RT.Table({
            c: RT.Column(jnp.asarray(d), None if v is None else jnp.asarray(v),
                         None if voc is None else RT.DictEncoding(voc))
            for c, (d, v, voc) in cols.items()
        })
        for t, cols in host.items()
    }
    for t in cat.values():
        t.compute_stats()
    return cat


def _port_catalog(host):
    cat = PT.catalog_from_numpy(host, "cpu")
    for t in cat.values():
        t.compute_stats()
    return cat


def _plan(pkg, node, catalog):
    R, O = (RR, RO) if pkg == "ref" else (PR, PO)
    wanted = R.output_columns(node, catalog)
    plan = O.optimize(node, catalog, required=set(wanted))
    if R.output_columns(plan, catalog) != wanted:
        plan = R.Project(plan, wanted)
    return plan


def _norm_explain(text: str) -> str:
    return re.sub(r"<repro(?:_torch)?\.core\.scalar\.(\w+) object at 0x[0-9a-f]+>",
                  r"<\1>", text)


def _host_rows(masked):
    """(mask, {col: (data, validity)}) as numpy, from either package's
    MaskedTable or anything carrying one as ``.masked``."""
    masked = getattr(masked, "masked", masked)

    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    cols = {n: (arr(c.data), arr(c.validity()))
            for n, c in masked.table.columns.items()}
    return arr(masked.mask), cols


def assert_same_rows(expected, got, label, rtol=1e-5, atol=1e-5):
    em, ecols = _host_rows(expected)
    gm, gcols = _host_rows(got)
    np.testing.assert_array_equal(em, gm, err_msg=f"{label}: mask")
    assert list(ecols) == list(gcols), f"{label}: schema"
    for n, (ev, evalid) in ecols.items():
        gv, gvalid = gcols[n]
        assert str(ev.dtype) == str(gv.dtype), f"{label}: dtype({n})"
        np.testing.assert_array_equal(evalid[em], gvalid[gm], err_msg=f"{label}: valid({n})")
        live = em & evalid
        if ev.dtype.kind == "f":
            np.testing.assert_allclose(gv[live], ev[live], rtol=rtol, atol=atol,
                                       err_msg=f"{label}: {n}")
        else:
            np.testing.assert_array_equal(gv[live], ev[live], err_msg=f"{label}: {n}")


#: query builders over a package's core module ``C`` (the same text builds
#: the reference's and the port's query)
QUERIES = {
    "filter_compute_project": lambda C: (
        C.scan("facts")
        .filter((C.col("qty") > 2) | C.col("val").is_null())
        .compute(x=C.col("val") * 2.0 + C.col("qty"),
                 y=C.case([(C.col("cat") == "red", C.col("qty"))], C.lit(-1)))
        .project("fk", "x", "y")),
    "sort_limit": lambda C: C.scan("facts").sort(("val", False), ("fk", True), limit=5),
    "sort_multi": lambda C: C.scan("facts").sort("cat", ("qty", False)),
    "join_inner": lambda C: C.scan("facts").join(C.scan("dims"), on=("fk", "dk")),
    "join_left": lambda C: C.scan("facts").join(C.scan("dims"), on=("fk", "dk"),
                                                kind="left"),
    "join_semi": lambda C: C.scan("facts").join(C.scan("dims"), on=("fk", "dk"),
                                                kind="semi"),
    "join_anti": lambda C: C.scan("facts").join(C.scan("dims"), on=("fk", "dk"),
                                                kind="anti"),
    "join_multi_inner": lambda C: C.scan("facts").join(
        C.scan("pairs"), on=[("fk", "a"), ("k2", "b")]),
    "join_multi_left": lambda C: C.scan("facts").join(
        C.scan("pairs"), on=[("fk", "a"), ("k2", "b")], kind="left"),
    "join_multi_semi": lambda C: C.scan("facts").join(
        C.scan("pairs"), on=[("fk", "a"), ("k2", "b")], kind="semi"),
    "join_multi_anti": lambda C: C.scan("facts").join(
        C.scan("pairs"), on=[("fk", "a"), ("k2", "b")], kind="anti"),
    "groupagg_sort": lambda C: C.scan("facts").group_by(
        "cat", "k2", s=C.sum_(C.col("val")), a=C.avg_(C.col("val")),
        c=C.count_(C.col("val")), n=C.count_(), mn=C.min_(C.col("val")),
        mx=C.max_(C.col("qty"))),
    "groupagg_dense": lambda C: C.scan("facts").group_by(
        "fk", s=C.sum_(C.col("val")), n=C.count_(), mx=C.max_(C.col("val"))),
    "groupagg_dict_key": lambda C: C.scan("facts").group_by(
        "cat", s=C.sum_(C.col("val")), a=C.avg_(C.col("qty")),
        c=C.count_(C.col("val")), n=C.count_()),
    "full_agg": lambda C: C.scan("facts").filter(C.col("qty") < 6).agg(
        s=C.sum_(C.col("val")), a=C.avg_(C.col("val")), mn=C.min_(C.col("qty")),
        mx=C.max_(C.col("val")), c=C.count_(C.col("val")), n=C.count_()),
    "uncorrelated_subqueries": lambda C: C.scan("dims").compute(
        t=C.scalar_subquery(C.scan("facts").agg(s=C.sum_(C.col("val"))), "s"),
        e=C.exists(C.scan("facts").filter(C.col("qty") > 7)),
        ne=C.not_exists(C.scan("facts").filter(C.col("qty") > 70)),
    ).project("dk", "t", "e", "ne"),
}


def _run(name, n_facts, pallas):
    host = _host(n_facts)
    rcat, pcat = _ref_catalog(host), _port_catalog(host)
    rplan = _plan("ref", QUERIES[name](RC).node, rcat)
    pplan = _plan("port", QUERIES[name](PC).node, pcat)
    assert _norm_explain(RO.explain(rplan)) == _norm_explain(PO.explain(pplan))
    expected = RC.Executor(rcat, use_pallas_agg=pallas).execute(rplan)
    got = PC.Executor(pcat, use_pallas_agg=pallas, device="cpu").execute(pplan)
    return expected, got, pplan


@pytest.mark.parametrize("n_facts", [41, 0], ids=["data", "empty"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_executor_parity(name, n_facts):
    expected, got, _ = _run(name, n_facts, pallas=False)
    assert_same_rows(expected, got, name)


@pytest.mark.parametrize("n_facts", [41, 0], ids=["data", "empty"])
@pytest.mark.parametrize("name", ["groupagg_dict_key", "groupagg_dense"])
def test_executor_parity_relagg_path(name, n_facts):
    """``use_pallas_agg``: a dictionary key (G = vocab size) and a dense int
    key with a capacity bound both take relagg."""
    expected, got, plan = _run(name, n_facts, pallas=True)
    assert_same_rows(expected, got, name)


def test_dense_range_annotated():
    _, _, plan = _run("groupagg_dense", 41, pallas=False)
    agg = next(n for n in PR.walk_plan(plan) if isinstance(n, PR.GroupAgg))
    assert agg.dense_range == (0, 6)


def _region_plan(R, S, passthrough: bool):
    region = R.Project(
        R.Compute(
            R.Compute(R.ConstantScan(), {"r1": S.Outer("val") * 2.0,
                                         "r2": S.Case([(S.Outer("qty") > 4, S.Const(1))],
                                                      S.Const(0))}),
            {"r3": S.ColRef("r1") + S.ColRef("r2")}),
        ["r3", "r2"])
    pt = (S.ColRef("qty") < 2) if passthrough else None
    return R.Apply(R.Scan("facts"), region, kind="outer", passthrough=pt)


@pytest.mark.parametrize("passthrough", [False, True])
@pytest.mark.parametrize("n_facts", [41, 0], ids=["data", "empty"])
def test_region_apply(passthrough, n_facts):
    host = _host(n_facts)
    rplan = _region_plan(RR, RS, passthrough)
    pplan = _region_plan(PR, PS, passthrough)
    assert _norm_explain(RO.explain(rplan)) == _norm_explain(PO.explain(pplan))
    expected = RC.Executor(_ref_catalog(host)).execute(rplan)
    got = PC.Executor(_port_catalog(host), device="cpu").execute(pplan)
    assert_same_rows(expected, got, "region apply")


def test_uncorrelated_apply():
    host = _host(41)
    rplan = RR.Apply(RR.Scan("dims"), RC.scan("facts").agg(s=RC.sum_(RC.col("val"))).node,
                     kind="cross")
    pplan = PR.Apply(PR.Scan("dims"), PC.scan("facts").agg(s=PC.sum_(PC.col("val"))).node,
                     kind="cross")
    expected = RC.Executor(_ref_catalog(host)).execute(rplan)
    got = PC.Executor(_port_catalog(host), device="cpu").execute(pplan)
    assert_same_rows(expected, got, "uncorrelated apply")


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("keys", [[("dk", "fk")], [("dk", "fk"), ("dk", "k2")]],
                         ids=["single", "multi"])
def test_empty_build_side_per_row_answer(kind, keys):
    """dims joined to an empty facts: no dims row has a match.  semi keeps
    none, anti keeps every row, inner keeps none, left keeps every row with
    NULL facts columns."""
    cat = _port_catalog(_host(0))
    plan = PC.scan("dims").join(PC.scan("facts"), on=keys, kind=kind).node
    got = PC.Executor(cat, device="cpu").execute(plan)
    n = cat["dims"].num_rows
    mask = got.mask.numpy()
    assert mask.shape == (n,)
    assert mask.all() == (kind in ("left", "anti")) and mask.any() == mask.all()
    if kind == "left":
        for c in ("val", "qty", "cat"):
            assert not got.table.columns[c].validity().numpy().any()


def _port_decorr_query(kind: str, keyshape: str):
    C, S = PC, PS
    outer = C.scan("keys")
    if keyshape == "direct":
        pred = C.col("fk") == S.Outer("k")
    elif keyshape == "expr":
        pred = C.col("fk") == S.Outer("k") + C.lit(3)
    else:
        outer = outer.compute(kk=C.col("k") + C.lit(1))
        pred = (C.col("fk") == S.Outer("k")) & (C.col("qty") == S.Outer("kk"))
    inner = C.scan("facts").filter(pred & (C.col("qty") >= C.param("minq")))
    if kind == "agg":
        return outer.compute(out=C.scalar_subquery(inner.agg(s=C.sum_(C.col("val"))),
                                                   "s")).project("k", "out")
    if kind == "exists":
        return outer.compute(out=C.exists(inner)).project("k", "out")
    if kind == "semi":
        return (outer.filter(C.exists(inner))
                .compute(out=C.col("k") * 2.0).project("k", "out"))
    return (outer.filter(C.not_exists(inner))
            .compute(out=C.col("k") * 2.0).project("k", "out"))


@pytest.mark.parametrize("n_rows", [23, 0], ids=["data", "empty"])
@pytest.mark.parametrize("keyshape", ["direct", "expr", "multi"])
@pytest.mark.parametrize("kind", ["semi", "anti", "agg", "exists"])
def test_decorrelated_matches_per_row(kind, keyshape, n_rows):
    """The decorrelated plan (keyed GroupAgg build joined back, semi/anti
    joins for Filter(EXISTS)) against the reference's per-row apply,
    including an empty inner relation (the reference's C1 crash)."""
    ref = make_session(1, n_rows)
    params = {"minq": 2}
    expected = _per_row_reference(ref, decorr_query(kind, keyshape), params)
    port = PC.Session(device="cpu")
    port.load_catalog({
        t: {c: (np.asarray(col.data), None, None) for c, col in tab.columns.items()}
        for t, tab in ref.catalog.items()
    })
    got = port.execute(_port_decorr_query(kind, keyshape), PC.FROID, params=params)
    assert_same_rows(expected, got, f"{kind}/{keyshape}", rtol=2e-3, atol=1e-3)
