"""Parity of ``repro_torch.tables.table`` with ``repro.tables.table``: the
same numpy inputs through both packages must give the same dtypes,
dictionary codes, statistics and civil-date arithmetic, exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.tables import table as RT
from repro_torch.tables import table as PT


def _arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = 97
    words = np.array(["delta", "alpha", "charlie", "bravo", "echo"])
    return dict(
        i64=rng.integers(-50, 50, n),
        i32=rng.integers(0, 9, n).astype(np.int32),
        f64=rng.normal(size=n),
        f32=rng.normal(size=n).astype(np.float32),
        flag=rng.random(n) > 0.5,
        word=words[rng.integers(0, len(words), n)],
        obj=np.array([f"k{v}" for v in rng.integers(0, 20, n)], dtype=object),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_from_arrays_dtypes_and_codes(seed):
    arrays = _arrays(seed)
    ref = RT.Table.from_arrays(**arrays).compute_stats()
    port = PT.Table.from_arrays("cpu", **arrays).compute_stats()
    assert ref.names() == port.names()
    for name in ref.names():
        a, b = ref.columns[name], port.columns[name]
        assert str(np.asarray(a.data).dtype) == str(b.data.numpy().dtype), name
        np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy(), err_msg=name)
        if a.dictionary is None:
            assert b.dictionary is None
        else:
            assert a.dictionary.vocab == b.dictionary.vocab, name
    assert ref.stats == port.stats


def test_from_arrays_empty_and_single_string():
    for arr in (np.array([], dtype=str), np.array(["only"] * 5)):
        ref = RT.Table.from_arrays(s=arr)
        port = PT.Table.from_arrays("cpu", s=arr)
        np.testing.assert_array_equal(np.asarray(ref.columns["s"].data),
                                      port.columns["s"].data.numpy())
        assert ref.columns["s"].dictionary.vocab == port.columns["s"].dictionary.vocab


def test_dictionary_key_is_made_once_per_growth():
    """The vocabulary key the interpreter's caches use: the same object
    until the vocabulary grows, equal across dictionaries exactly when
    their vocabularies are equal, the reference's codes kept."""
    words = ["delta", "alpha", "charlie"]
    enc, ref = PT.DictEncoding(words), RT.DictEncoding(words)
    key = enc.key
    assert enc.key is key and key.vocab == tuple(words)
    assert enc.code("alpha") == ref.code("alpha") == 1 and enc.key is key
    other = PT.DictEncoding(words)
    assert other.key == key and hash(other.key) == hash(key)
    assert enc.code("bravo") == ref.code("bravo") == 3
    assert enc.key is not key and enc.key != key and enc.key != other.key
    assert enc.key.vocab == tuple(words) + ("bravo",)
    assert PT.DictEncoding().key == PT.DictEncoding().key != key


def test_catalog_from_numpy_keeps_codes():
    ref = RT.Table.from_arrays(**_arrays(3))
    host = {"t": {c: (np.asarray(col.data), None,
                      None if col.dictionary is None else col.dictionary.vocab)
                  for c, col in ref.columns.items()}}
    valid = np.arange(97) % 3 != 0
    host["t"]["f32"] = (host["t"]["f32"][0], valid, None)
    cat = PT.catalog_from_numpy(host, "cpu")
    t = cat["t"]
    assert t.columns["i64"].data.dtype == torch.int32
    assert t.columns["f64"].data.dtype == torch.float32
    np.testing.assert_array_equal(t.columns["word"].data.numpy(),
                                  np.asarray(ref.columns["word"].data))
    assert t.columns["word"].dictionary.vocab == ref.columns["word"].dictionary.vocab
    np.testing.assert_array_equal(t.columns["f32"].validity().numpy(), valid)
    assert t.to_numpy()["word"].tolist() == ref.to_numpy()["word"].tolist()


def test_gather_clamps_like_take_clip():
    arrays = _arrays(4)
    ref = RT.Table.from_arrays(**arrays)
    port = PT.Table.from_arrays("cpu", **arrays)
    idx = np.array([-5, 0, 3, 96, 97, 500])
    a = ref.gather(jnp.asarray(idx))
    b = port.gather(torch.as_tensor(idx))
    for name in a.names():
        np.testing.assert_array_equal(np.asarray(a.columns[name].data),
                                      b.columns[name].data.numpy(), err_msg=name)
    assert ref.nbytes() == port.nbytes()


def _days_sweep() -> np.ndarray:
    rng = np.random.default_rng(7)
    fixed = np.array([-719468, -719469, -146097, -1, 0, 1, 59, 60, 789, 10957,
                      11016, 11017, 11382, 11383, 2932896, -2932896])
    return np.concatenate([fixed, rng.integers(-1_000_000, 1_000_000, 4000),
                           np.arange(-1500, 1500)]).astype(np.int32)


def test_civil_from_days_sweep():
    z = _days_sweep()
    ref = RT.civil_from_days(jnp.asarray(z))
    port = PT.civil_from_days(torch.as_tensor(z))
    for r, p in zip(ref, port):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(r), p.numpy())


def test_days_from_civil_sweep_with_leap_years():
    years = np.arange(-450, 2450, 7, dtype=np.int32)
    y, m, d = np.meshgrid(years, np.arange(1, 13), np.array([1, 15, 28, 29, 31]),
                          indexing="ij")
    y, m, d = (a.reshape(-1).astype(np.int32) for a in (y, m, d))
    ref = RT.days_from_civil(jnp.asarray(y), jnp.asarray(m), jnp.asarray(d))
    port = PT.days_from_civil(torch.as_tensor(y), torch.as_tensor(m),
                              torch.as_tensor(d))
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())
    # Feb 29 round-trips exactly in leap years (divisible by 4, not by 100
    # unless by 400), including negative (proleptic) years
    leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0)) & (m == 2) & (d == 29)
    back = PT.civil_from_days(port[torch.as_tensor(leap)])
    np.testing.assert_array_equal(back[2].numpy(), 29)


@pytest.mark.parametrize("part", ["dd", "mm", "yy"])
def test_date_add_sweep(part):
    z = _days_sweep()
    n = np.random.default_rng(1).integers(-40, 40, len(z)).astype(np.int32)
    ref = RT.date_add(part, jnp.asarray(n), jnp.asarray(z))
    port = PT.date_add(part, torch.as_tensor(n), torch.as_tensor(z))
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())


@pytest.mark.parametrize("part", ["yy", "mm", "dd", "dw"])
def test_date_part_sweep(part):
    z = _days_sweep()
    np.testing.assert_array_equal(np.asarray(RT.date_part(part, jnp.asarray(z))),
                                  PT.date_part(part, torch.as_tensor(z)).numpy())
