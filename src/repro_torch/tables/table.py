"""Port of ``src/repro/tables/table.py:1-270``: columnar tables over torch
tensors.

One contiguous tensor per column plus an optional validity mask (SQL NULL
semantics), resident on the session's device.  Strings are dictionary-
encoded (int32 codes into a host-side vocabulary); dates are int32 days
since 1970-01-01, with the civil-day math in integer torch ops so the date
intrinsics stay vectorized on the device.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Mapping, Sequence

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``None`` means the card.  Raises where
    CUDA is absent — only an explicit ``"cpu"`` runs on the host.  A card
    is named with its index (``cuda`` becomes ``cuda:<current>``), so it
    compares equal to the device of a tensor made there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

# ---------------------------------------------------------------------------
# Dictionary encoding for string columns (host side, unchanged)
# ---------------------------------------------------------------------------


class DictEncoding:
    """A host-side vocabulary assigning int32 codes to strings."""

    def __init__(self, values: Sequence[str] = ()):
        self._to_code: dict[str, int] = {}
        self._from_code: list[str] = []
        for v in values:
            self.code(v)

    def code(self, value: str) -> int:
        c = self._to_code.get(value)
        if c is None:
            c = len(self._from_code)
            self._to_code[value] = c
            self._from_code.append(value)
        return c

    def lookup(self, value: str) -> int:
        """Code for ``value`` or -1 if absent (compares false against all)."""
        return self._to_code.get(value, -1)

    def decode(self, code: int) -> str:
        return self._from_code[int(code)]

    @property
    def vocab(self) -> tuple[str, ...]:
        """The code -> string table, in code order (round-trips the
        encoding: ``DictEncoding(enc.vocab)`` assigns identical codes)."""
        return tuple(self._from_code)

    def __len__(self) -> int:
        return len(self._from_code)

    def like_mask(self, pattern: str) -> np.ndarray:
        """Bool mask over the vocabulary for a SQL LIKE pattern (``%``
        wildcards).  Evaluated host-side once per query; on the device LIKE
        becomes a gather into this mask."""
        pat = pattern.replace("%", "*")
        return np.array(
            [fnmatch.fnmatchcase(v, pat) for v in self._from_code], dtype=bool
        )


def _encode_strings(a: np.ndarray) -> tuple[np.ndarray, DictEncoding]:
    """Dictionary codes in first-appearance order, as the reference's
    per-row loop assigns them (``table.py:198-199``), computed with one
    ``np.unique`` instead of a Python loop over every row."""
    if a.dtype.kind != "U":
        a = np.array([str(v) for v in a.reshape(-1)], dtype=str)
    uniq, first, inverse = np.unique(a, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    codes = rank[inverse.reshape(-1)].astype(np.int32)
    return codes, DictEncoding(uniq[order].tolist())


# ---------------------------------------------------------------------------
# Civil-date <-> day-number conversions (Howard Hinnant's algorithms), in
# int32 torch ops.  Tensor ``//`` and ``%`` floor like ``jnp``'s.
# ---------------------------------------------------------------------------


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32)


def days_from_civil(y, m, d):
    """days since 1970-01-01 from (year, month, day)."""
    y, m, d = _i32(y), _i32(m), _i32(d)
    y = y - (m <= 2).to(torch.int32)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def civil_from_days(z):
    """(year, month, day) from days since epoch."""
    z = _i32(z) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(torch.int32)
    return y, m, d


def date_add(part: str, n, days):
    """SQL DATEADD on day-number dates.  part in {dd, mm, yy}."""
    days = _i32(days)
    n = _i32(n).to(days.device)
    if part in ("dd", "day"):
        return days + n
    y, m, d = civil_from_days(days)
    if part in ("yy", "year"):
        return days_from_civil(y + n, m, d)
    if part in ("mm", "month"):
        tot = (y * 12 + (m - 1)) + n
        return days_from_civil(tot // 12, tot % 12 + 1, d)
    raise ValueError(f"unsupported DATEADD part {part!r}")


def date_part(part: str, days):
    """SQL DATEPART on day-number dates.  part in {yy, mm, dd, dw}."""
    y, m, d = civil_from_days(days)
    if part in ("yy", "year"):
        return y
    if part in ("mm", "month"):
        return m
    if part in ("dd", "day"):
        return d
    if part == "dw":  # 1=Sunday..7=Saturday (1970-01-01 was a Thursday)
        return (_i32(days) + 4) % 7 + 1
    raise ValueError(f"unsupported DATEPART part {part!r}")


# ---------------------------------------------------------------------------
# Columns and Tables
# ---------------------------------------------------------------------------


def _host_array(a: np.ndarray) -> np.ndarray:
    """The reference's column casts: int64 -> int32, float64 -> float32."""
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


@dataclasses.dataclass
class Column:
    """One column: data tensor + optional validity (True == non-NULL) +
    optional dictionary for string columns."""

    data: torch.Tensor
    valid: torch.Tensor | None = None  # None means all-valid
    dictionary: DictEncoding | None = None

    @property
    def dtype(self):
        return self.data.dtype

    def validity(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.data.shape, dtype=torch.bool,
                              device=self.data.device)
        return self.valid


class Table:
    """An ordered mapping name -> Column with uniform row count."""

    def __init__(self, columns: Mapping[str, Column] | None = None):
        self.columns: dict[str, Column] = dict(columns or {})
        # per-column statistics (n_distinct, min, max) — populated by
        # compute_stats(); drives capacity hints in the query optimizer
        self.stats: dict[str, tuple[int, int, int]] = {}
        if self.columns:
            n = {int(c.data.shape[0]) for c in self.columns.values()}
            if len(n) != 1:
                raise ValueError(f"ragged table: row counts {n}")

    def compute_stats(self) -> "Table":
        """Column statistics for integer/dictionary columns (the costing
        input the paper notes UDFs used to hide, §2.3), computed where the
        column lives."""
        for name, c in self.columns.items():
            if c.dictionary is not None:
                self.stats[name] = (len(c.dictionary), 0, len(c.dictionary) - 1)
            elif (not c.data.is_floating_point() and c.data.dtype != torch.bool
                  and c.data.numel()):
                u = torch.unique(c.data)
                self.stats[name] = (int(u.numel()), int(u[0]), int(u[-1]))
        return self

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_arrays(device=None, /, **arrays) -> "Table":
        """Build a table on ``device`` (``None`` means the card, see
        :func:`resolve_device`) from host arrays (strings are
        dictionary-encoded) or ready :class:`Column` objects."""
        device = resolve_device(device)
        cols = {}
        for name, arr in arrays.items():
            if isinstance(arr, Column):
                cols[name] = arr
                continue
            a = np.asarray(arr)
            if a.dtype.kind in ("U", "S", "O"):  # strings -> dict encode
                codes, enc = _encode_strings(a)
                cols[name] = Column(torch.as_tensor(codes, device=device),
                                    dictionary=enc)
            else:
                cols[name] = Column(torch.as_tensor(_host_array(a),
                                                    device=device))
        return Table(cols)

    # -- basic ops ---------------------------------------------------------
    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 1  # ConstantScan semantics: one row, no columns
        return int(next(iter(self.columns.values())).data.shape[0])

    def names(self) -> list[str]:
        return list(self.columns.keys())

    def devices(self) -> set[torch.device]:
        """Every device a column's data or validity lies on."""
        out = set()
        for c in self.columns.values():
            out.add(c.data.device)
            if c.valid is not None:
                out.add(c.valid.device)
        return out

    def column(self, name: str) -> Column:
        return self.columns[name]

    def with_column(self, name: str, col: Column) -> "Table":
        cols = dict(self.columns)
        cols[name] = col
        return Table(cols)

    def project(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self.columns.items()})

    def gather(self, idx: torch.Tensor, valid: torch.Tensor | None = None
               ) -> "Table":
        """Row gather; optionally invalidates rows where ``valid`` is False
        (used for outer-join null padding).  Indices are clamped into range,
        as ``jnp.take(mode="clip")`` does in the reference (``:238``)."""
        cols = {}
        for n, c in self.columns.items():
            if c.data.shape[0] == 0:
                # nothing to gather from (an empty build side): NULL rows
                shape = tuple(idx.shape) + tuple(c.data.shape[1:])
                data = torch.zeros(shape, dtype=c.data.dtype, device=c.data.device)
                v = torch.zeros(idx.shape, dtype=torch.bool, device=c.data.device)
            else:
                safe = idx.clamp(0, int(c.data.shape[0]) - 1)
                data = c.data[safe]
                v = c.validity()[safe]
            if valid is not None:
                v = v & valid
            cols[n] = Column(data, v, c.dictionary)
        return Table(cols)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Materialize to host, decoding dictionaries (NULL values are raw;
        use ``valids``)."""
        out = {}
        for n, c in self.columns.items():
            arr = c.data.cpu().numpy()
            if c.dictionary is not None:
                arr = np.array([c.dictionary.decode(v) for v in arr], dtype=object)
            out[n] = arr
        return out

    def valids(self) -> dict[str, np.ndarray]:
        return {n: c.validity().cpu().numpy() for n, c in self.columns.items()}

    def nbytes(self) -> int:
        tot = 0
        for c in self.columns.values():
            tot += c.data.numel() * c.data.element_size()
            if c.valid is not None:
                tot += c.valid.numel()
        return tot

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.dtype}" for n, c in self.columns.items())
        return f"Table[{self.num_rows} rows]({cols})"


def catalog_from_numpy(tables: Mapping[str, Mapping[str, tuple]],
                       device) -> dict[str, Table]:
    """Build a catalog from host arrays: ``{table: {column: (data,
    valid_or_None, vocab_or_None)}}``.  ``vocab`` is the code -> string
    tuple of a dictionary column, so the codes carried across are exactly
    the source's.  The reference's int64/float64 casts apply."""
    out = {}
    for tname, cols in tables.items():
        built = {}
        for cname, (data, valid, vocab) in cols.items():
            data = torch.tensor(_host_array(np.asarray(data)), device=device)
            if valid is not None:
                valid = torch.as_tensor(np.asarray(valid, dtype=bool),
                                        device=device)
            enc = None if vocab is None else DictEncoding(vocab)
            built[cname] = Column(data, valid, enc)
        out[tname] = Table(built)
    return out
