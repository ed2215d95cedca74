"""Parity of the port's scalar evaluator with the reference's
``eval_scalar``: one expression sweep over columns with NULLs and
dictionary columns, built in each package's IR from the same numpy data.
Ints and bools must match exactly, floats to rtol 1e-6, and validity
exactly; the result dtypes must agree too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scalar as RS
from repro.tables.table import DictEncoding as RDict
from repro_torch.core import scalar as PS
from repro_torch.tables.table import DictEncoding as PDict

N = 64
WORDS = ("apple", "banana", "cherry", "avocado")


def _data():
    rng = np.random.default_rng(11)
    j = rng.integers(-6, 7, N).astype(np.int32)
    j[::5] = 0
    g = np.round(rng.uniform(-3, 3, N), 1).astype(np.float32)
    g[::7] = 0.0
    return {
        # name: (data, valid or None, vocab or None)
        "f": (rng.normal(size=N).astype(np.float32), rng.random(N) > 0.2, None),
        "g": (g, None, None),
        "i": (rng.integers(-20, 20, N).astype(np.int32), rng.random(N) > 0.25, None),
        "j": (j, None, None),
        "b": (rng.random(N) > 0.5, rng.random(N) > 0.1, None),
        "s": (rng.integers(0, len(WORDS), N).astype(np.int32),
              rng.random(N) > 0.2, WORDS),
        "d": (rng.integers(-4000, 12000, N).astype(np.int32), None, None),
        "e": (rng.integers(8000, 12000, N).astype(np.int32), rng.random(N) > 0.1, None),
    }


def _ref_env():
    return {n: RS.Value(jnp.asarray(d), None if v is None else jnp.asarray(v),
                        None if voc is None else RDict(voc))
            for n, (d, v, voc) in _data().items()}


def _port_env():
    return {n: PS.Value(torch.as_tensor(d), None if v is None else torch.as_tensor(v),
                        None if voc is None else PDict(voc))
            for n, (d, v, voc) in _data().items()}


def _c(S, name):
    return S.ColRef(name)


#: (id, builder(S, float32 tag, int32 tag, bool tag)) — each builder makes
#: the same expression in whichever package's IR module ``S`` it is given
EXPRS = [
    ("add_int", lambda S, F, I, B: _c(S, "i") + _c(S, "j")),
    ("sub_int", lambda S, F, I, B: _c(S, "i") - _c(S, "j")),
    ("mul_mixed", lambda S, F, I, B: _c(S, "f") * _c(S, "i")),
    ("add_const", lambda S, F, I, B: _c(S, "i") + 7),
    ("neg_float", lambda S, F, I, B: -_c(S, "f")),
    ("mod_int", lambda S, F, I, B: _c(S, "i") % _c(S, "j")),
    ("mod_int_const", lambda S, F, I, B: _c(S, "i") % -4),
    ("mod_float", lambda S, F, I, B: _c(S, "f") % _c(S, "g")),
    ("floordiv_int", lambda S, F, I, B: _c(S, "i") // _c(S, "j")),
    ("floordiv_float", lambda S, F, I, B: _c(S, "f") // _c(S, "g")),
    ("div_int_by_zero", lambda S, F, I, B: _c(S, "i") / _c(S, "j")),
    ("div_float", lambda S, F, I, B: _c(S, "f") / _c(S, "g")),
    ("div_const_zero", lambda S, F, I, B: _c(S, "f") / 0),
    ("lt", lambda S, F, I, B: _c(S, "i") < _c(S, "j")),
    ("ge_float", lambda S, F, I, B: _c(S, "f") >= _c(S, "g")),
    ("eq_const", lambda S, F, I, B: _c(S, "i") == 3),
    ("ne_float_const", lambda S, F, I, B: _c(S, "g") != 1.5),
    ("eq_str", lambda S, F, I, B: _c(S, "s") == "banana"),
    ("ne_str_absent", lambda S, F, I, B: _c(S, "s") != "durian"),
    ("and_nulls", lambda S, F, I, B: (_c(S, "i") > 0) & (_c(S, "f") < 0)),
    ("or_nulls", lambda S, F, I, B: (_c(S, "i") > 0) | _c(S, "b")),
    ("not_nulls", lambda S, F, I, B: ~_c(S, "b")),
    ("and3", lambda S, F, I, B: S.BoolOp("and", [_c(S, "b"), _c(S, "f") > 0,
                                                  _c(S, "j") != 0])),
    ("case_float", lambda S, F, I, B: S.Case(
        [(_c(S, "i") > 0, _c(S, "f")), (_c(S, "j") < 0, S.Const(1.0))],
        S.Const(None))),
    ("case_int_float", lambda S, F, I, B: S.Case([(_c(S, "b"), _c(S, "i"))],
                                                 _c(S, "g"))),
    ("case_str", lambda S, F, I, B: S.Case([(_c(S, "b"), _c(S, "s"))],
                                           S.Const("zz")) == "zz"),
    ("cast_f_int", lambda S, F, I, B: S.Cast(_c(S, "f") * 10.0, I)),
    ("cast_i_float", lambda S, F, I, B: S.Cast(_c(S, "i"), F)),
    ("cast_j_bool", lambda S, F, I, B: S.Cast(_c(S, "j"), B)),
    ("cast_64bit_tags", lambda S, F, I, B: S.Cast(S.Cast(_c(S, "f"), "float64"), "int64")),
    ("coalesce", lambda S, F, I, B: S.Coalesce([_c(S, "f"), _c(S, "g"), S.Const(0.0)])),
    ("coalesce_str", lambda S, F, I, B: S.Coalesce([_c(S, "s"), S.Const("none")])
     == "none"),
    ("isnull_f", lambda S, F, I, B: S.IsNull(_c(S, "f"))),
    ("isnull_s", lambda S, F, I, B: S.IsNull(_c(S, "s"))),
    ("like_prefix", lambda S, F, I, B: S.Like(_c(S, "s"), "a%")),
    ("like_suffix", lambda S, F, I, B: S.Like(_c(S, "s"), "%na")),
    ("inlist_str", lambda S, F, I, B: S.InList(_c(S, "s"), ["apple", "zz", "cherry"])),
    ("inlist_int", lambda S, F, I, B: S.InList(_c(S, "i"), [1, 2, -3])),
    ("inlist_float", lambda S, F, I, B: S.InList(_c(S, "g"), [0.5, 1, -1.5])),
    ("between_int", lambda S, F, I, B: S.Between(_c(S, "i"), -2, 5)),
    ("between_float", lambda S, F, I, B: S.Between(_c(S, "f"), _c(S, "g"), 1.0)),
    ("abs", lambda S, F, I, B: S.Func("abs", [_c(S, "i")])),
    ("floor", lambda S, F, I, B: S.Func("floor", [_c(S, "f") * 3.0])),
    ("floor_int", lambda S, F, I, B: S.Func("floor", [_c(S, "j")])),
    ("ceiling", lambda S, F, I, B: S.Func("ceiling", [_c(S, "f") * 3.0])),
    ("round", lambda S, F, I, B: S.Func("round", [_c(S, "g") * 5.0])),
    ("sqrt", lambda S, F, I, B: S.Func("sqrt", [_c(S, "g")])),
    ("sqrt_int", lambda S, F, I, B: S.Func("sqrt", [_c(S, "i")])),
    ("exp", lambda S, F, I, B: S.Func("exp", [_c(S, "f")])),
    ("log", lambda S, F, I, B: S.Func("log", [_c(S, "g")])),
    ("log_int", lambda S, F, I, B: S.Func("log", [_c(S, "j")])),
    ("power", lambda S, F, I, B: S.Func("power", [_c(S, "f"), 2])),
    ("sign", lambda S, F, I, B: S.Func("sign", [_c(S, "j")])),
    ("least", lambda S, F, I, B: S.Func("least", [_c(S, "i"), _c(S, "j")])),
    ("greatest_mixed", lambda S, F, I, B: S.Func("greatest", [_c(S, "f"), _c(S, "j")])),
    ("dateadd_dd", lambda S, F, I, B: S.Func("dateadd", [S.Const("dd"), _c(S, "j"),
                                                          _c(S, "d")])),
    ("dateadd_mm", lambda S, F, I, B: S.Func("dateadd", [S.Const("mm"), _c(S, "i"),
                                                          _c(S, "d")])),
    ("dateadd_yy", lambda S, F, I, B: S.Func("dateadd", [S.Const("yy"), 3,
                                                          _c(S, "e")])),
    ("datepart_yy", lambda S, F, I, B: S.Func("datepart", [S.Const("yy"), _c(S, "d")])),
    ("datepart_mm", lambda S, F, I, B: S.Func("datepart", [S.Const("mm"), _c(S, "e")])),
    ("datepart_dd", lambda S, F, I, B: S.Func("datepart", [S.Const("dd"), _c(S, "d")])),
    ("datepart_dw", lambda S, F, I, B: S.Func("datepart", [S.Const("dw"), _c(S, "d")])),
    ("datediff", lambda S, F, I, B: S.Func("datediff_days", [S.Const("dd"), _c(S, "d"),
                                                               _c(S, "e")])),
    ("const_null_plus", lambda S, F, I, B: _c(S, "i") + S.Const(None, I)),
    ("const_only", lambda S, F, I, B: S.Const(2.5) * 4),
]


@pytest.mark.parametrize("build", [b for _, b in EXPRS], ids=[i for i, _ in EXPRS])
def test_expression_parity(build):
    ref = RS.eval_scalar(build(RS, jnp.float32, jnp.int32, jnp.bool_),
                         _ref_env(), RS.EvalContext(num_rows=N))
    port = PS.eval_scalar(build(PS, np.float32, np.int32, np.bool_),
                          _port_env(), PS.EvalContext(num_rows=N, device="cpu"))
    rd, rv = np.asarray(ref.data), np.asarray(ref.validity())
    pd, pv = port.data.numpy(), port.validity().numpy()
    assert str(rd.dtype) == str(pd.dtype), (rd.dtype, pd.dtype)
    assert rd.shape == pd.shape
    np.testing.assert_array_equal(rv, pv)
    live = np.broadcast_to(rv, rd.shape)
    if rd.dtype.kind == "f":
        np.testing.assert_allclose(pd[live], rd[live], rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(pd[live], rd[live])
    assert (ref.dictionary is None) == (port.dictionary is None)
    if ref.dictionary is not None:
        assert ref.dictionary.vocab == port.dictionary.vocab


def test_constants_default_to_cpu_and_int32():
    v = PS.eval_scalar(PS.Const(5), {}, PS.EvalContext())
    assert v.data.dtype == torch.int32 and v.data.device.type == "cpu"
    assert PS.eval_scalar(PS.Const(0.1), {}, PS.EvalContext()).data.dtype == torch.float32
    assert PS.torch_dtype(np.float32) is torch.float32
    assert PS.torch_dtype(jnp.int32) is torch.int32
