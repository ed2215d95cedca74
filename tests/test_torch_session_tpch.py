"""The slice end to end on the CPU: TPC-H at the generator's minimum size
(``sf=0.001``), loaded into a reference ``Session`` and, through
``catalog_from_numpy``, into a port ``Session``; Q1, Q3, Q5, Q6, Q12 and
Q14 in their UDF and original forms, under FROID with ``pallas_agg`` off
and on.

``explain()`` must be equal (object addresses of IR nodes without a
``repr`` aside); the compacted rows must be equal in order — keys, counts
and validity exactly, float aggregates to rtol 1e-4.  The reference runs
eagerly (``FROID.eager()``: the same results without a jit compile per
plan), with its relagg kernel in Pallas interpret mode."""
import re
import sys

import numpy as np
import pytest
import torch

import repro.core as RC
from repro.data.tpch import generate_tpch as ref_generate
import repro_torch.core as PC
from repro_torch.core import executor as PE
from repro_torch.data.tpch_udfs import QUERIES as PORT_QUERIES
from repro_torch.data.tpch_udfs import register_udfs as port_register
from repro_torch.tables import table as PT

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
from benchmarks.tpch_udfs import QUERIES as REF_QUERIES  # noqa: E402
from benchmarks.tpch_udfs import register_udfs as ref_register  # noqa: E402

NAMES = ["Q1", "Q3", "Q5", "Q6", "Q12", "Q14"]


def export_catalog(session) -> dict:
    """A reference Session's catalog as host arrays for
    ``Session.load_catalog``."""
    return {
        t: {c: (np.asarray(col.data),
                None if col.valid is None else np.asarray(col.valid),
                None if col.dictionary is None else col.dictionary.vocab)
            for c, col in tab.columns.items()}
        for t, tab in session.catalog.items()
    }


@pytest.fixture(scope="module")
def sessions():
    ref = RC.Session()
    ref_generate(ref, sf=0.001)
    ref_register(ref)
    port = PC.Session(device="cpu")
    port.load_catalog(export_catalog(ref))
    port_register(port)
    return ref, port


def _norm_explain(text: str) -> str:
    return re.sub(r"<repro(?:_torch)?\.core\.scalar\.(\w+) object at 0x[0-9a-f]+>",
                  r"<\1>", text)


def assert_rows_equal(expected_table, got_table, label):
    e, g = expected_table, got_table
    assert e.names() == g.names(), label
    assert e.num_rows == g.num_rows, label
    for name in e.names():
        ec, gc = e.columns[name], g.columns[name]
        ev, gv = np.asarray(ec.data), gc.data.numpy()
        assert str(ev.dtype) == str(gv.dtype), f"{label}: dtype({name})"
        evalid, gvalid = np.asarray(ec.validity()), gc.validity().numpy()
        np.testing.assert_array_equal(evalid, gvalid, err_msg=f"{label}: valid({name})")
        if ev.dtype.kind == "f":
            np.testing.assert_allclose(gv[evalid], ev[evalid], rtol=1e-4,
                                       err_msg=f"{label}: {name}")
        else:
            np.testing.assert_array_equal(gv[evalid], ev[evalid], err_msg=f"{label}: {name}")
        if ec.dictionary is not None:
            assert ec.dictionary.vocab == gc.dictionary.vocab


@pytest.mark.parametrize("pallas", [False, True], ids=["plain_agg", "relagg"])
@pytest.mark.parametrize("form", [0, 1], ids=["udf", "orig"])
@pytest.mark.parametrize("name", NAMES)
def test_tpch_query_parity(sessions, name, form, pallas):
    ref, port = sessions
    rstmt = ref.prepare(REF_QUERIES[name][form](),
                        RC.ExecutionPolicy(name="r", pallas_agg=pallas).eager())
    pstmt = port.prepare(PORT_QUERIES[name][form](),
                         PC.ExecutionPolicy(name="p", pallas_agg=pallas))
    assert _norm_explain(rstmt.explain()) == _norm_explain(pstmt.explain())
    cold = pstmt.execute()
    warm = pstmt.execute()
    assert not cold.cache_hit and warm.cache_hit
    expected = rstmt.execute().table
    assert_rows_equal(expected, cold.table, f"{name}[{form}] cold")
    assert_rows_equal(expected, warm.table, f"{name}[{form}] warm")


def test_eager_policy_matches_compiled(sessions):
    _, port = sessions
    q = PORT_QUERIES["Q12"][0]()
    a = port.prepare(q, PC.FROID).execute().table
    eager = port.prepare(q, PC.FROID.eager())
    cold, warm = eager.execute(), eager.execute()
    assert not cold.cache_hit and warm.cache_hit
    for n in a.names():
        assert torch.equal(a.columns[n].data, warm.table.columns[n].data)


def test_session_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PC.Session()
    with pytest.raises(RuntimeError, match="CUDA"):
        PE.Executor({})
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.Table.from_arrays(x=np.arange(3))
    assert PC.Session(device="cpu").device.type == "cpu"


def test_create_table_rejects_another_device():
    port = PC.Session(device="cpu")
    elsewhere = PT.Table.from_arrays("meta", x=np.arange(4, dtype=np.float32))
    with pytest.raises(ValueError, match="meta"):
        port.create_table("t", elsewhere)
    assert "t" not in port.catalog
    here = PT.Table.from_arrays("cpu", x=np.arange(4, dtype=np.float32))
    assert port.create_table("t", here) is here


@pytest.mark.parametrize("policy", [PC.INTERPRETED, PC.HEKATON, PC.ROUTED],
                         ids=lambda p: p.name)
def test_unported_policies_raise(sessions, policy):
    """Every preset now runs: INTERPRETED and HEKATON on the per-row
    interpreter, ROUTED through the cost router (which attaches to the
    session and samples the call); each gives the reference's answer to
    the same call (Q6 in its UDF form, the whole catalog)."""
    ref, port = sessions
    got = port.prepare(PORT_QUERIES["Q6"][0](), policy).execute()
    want = ref.execute(REF_QUERIES["Q6"][0](), RC.PRESETS[policy.name])
    assert_rows_equal(want.table, got.table, policy.name)
    if policy is PC.ROUTED:
        assert port.cost_stats["enabled"] and port.cost_stats["samples"] >= 1
        return
    assert got.stats["udf_rows"] == ref.catalog["lineitem"].num_rows


def test_uninlined_udf_call_raises():
    """With inlining off, FROID's plan keeps the UDF call; it now runs on
    the scan-mode interpreter and gives the reference's answer."""
    tables, answers = [], []
    for M, kw in ((RC, {}), (PC, {"device": "cpu"})):
        s = M.Session(constraints=M.InlineConstraints(enabled=False), **kw)
        s.create_table("t", x=np.arange(5, dtype=np.float32))
        u = M.UdfBuilder("twice", [("v", "float32")], "float32")
        u.return_(M.param("v") * 2.0)
        s.create_function(u.build())
        r = s.execute(M.scan("t").compute(y=M.udf("twice", M.col("x"))))
        answers.append(r)
        tables.append(r.table)
    assert answers[1].stats["udf_rows"] == 5
    np.testing.assert_array_equal(tables[1].columns["y"].data.numpy(),
                                  [0.0, 2.0, 4.0, 6.0, 8.0])
    assert_rows_equal(tables[0], tables[1], "inlining off")
