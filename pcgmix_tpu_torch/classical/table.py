"""A column table just large enough for the classical pipeline, with the
pandas rules that the JAX package's CSVs follow.

Columns are 1-D numpy arrays in order: int64, float64, bool, or object
(strings, NaN where a field was empty).  ``read_csv`` infers a column's
type as ``pandas.read_csv`` does for these files: all fields integers →
int64; any float or empty field → float64; ``True``/``False`` → bool;
anything else → strings.  Floats are parsed with ``float()``, which is
exact: pandas' default parser lands an ulp away from the written value for
about a third of 17-digit fields, so a table read back here equals the one
written, where one read back by pandas may not.  ``to_csv`` writes what
``DataFrame.to_csv(index=False)`` writes.
"""

from __future__ import annotations

import csv
import re

import numpy as np

from pcgmix_tpu_torch.classical.features import _csv_field

_INT = re.compile(r"[+-]?\d+\Z")
# pandas' default NA strings (``read_csv``'s ``na_values``)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_BOOLS = {"True": True, "False": False, "TRUE": True, "FALSE": False, "true": True,
          "false": False}


def _column(values: list) -> np.ndarray:
    """A column from Python values, typed as ``pd.DataFrame(rows)`` types it:
    all ints → int64, all bools → bool, ints and floats (NaN or None for a
    missing value) → float64, anything else → object."""
    kinds = set()
    for v in values:
        if v is None:
            kinds.add("na")
        elif isinstance(v, (bool, np.bool_)):
            kinds.add("b")
        elif isinstance(v, (int, np.integer)):
            kinds.add("i")
        elif isinstance(v, (float, np.floating)):
            kinds.add("f")
        else:
            kinds.add("o")
    if kinds == {"i"}:
        return np.array(values, dtype=np.int64)
    if kinds == {"b"}:
        return np.array(values, dtype=bool)
    if kinds and kinds <= {"i", "f", "na"}:
        return np.array([np.nan if v is None else v for v in values], dtype=np.float64)
    col = np.empty(len(values), dtype=object)
    col[:] = [np.nan if v is None else v for v in values]
    return col


def _parse(fields: list) -> np.ndarray:
    """A CSV column typed as ``pandas.read_csv`` types it (see the module)."""
    present = [f for f in fields if f not in NA_STRINGS]
    if len(present) == len(fields) and all(_INT.match(f) for f in present):
        return np.array([int(f) for f in fields], dtype=np.int64)
    try:
        return np.array([np.nan if f in NA_STRINGS else float(f) for f in fields],
                        dtype=np.float64)
    except ValueError:
        pass
    col = np.empty(len(fields), dtype=object)
    if present and all(f in _BOOLS for f in present):
        if len(present) == len(fields):
            return np.array([_BOOLS[f] for f in fields], dtype=bool)
        col[:] = [_BOOLS.get(f, np.nan) for f in fields]
        return col
    col[:] = [np.nan if f in NA_STRINGS else f for f in fields]
    return col


def _strings(col: np.ndarray) -> list[str]:
    """A column's CSV fields (``_csv_field``, a column at a time)."""
    values = col.tolist()
    if col.dtype.kind == "f":
        return ["" if v != v else repr(v) for v in values]
    if col.dtype.kind in "iub":
        return [str(v) for v in values]
    return [_csv_field(v) for v in values]


class Table:
    """Named columns of equal length, in order."""

    def __init__(self, columns: dict | None = None):
        self.data: dict[str, np.ndarray] = dict(columns or {})
        lengths = {len(v) for v in self.data.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")

    @classmethod
    def from_rows(cls, rows: list[dict]) -> "Table":
        """``pd.DataFrame(rows)``: columns in order of first appearance, a
        key that a row lacks as a missing value."""
        names: dict = {}
        for row in rows:
            names.update(dict.fromkeys(row))
        return cls({c: _column([row.get(c) for row in rows]) for c in names})

    @classmethod
    def read_csv(cls, path: str) -> "Table":
        with open(path, newline="") as f:
            lines = list(csv.reader(f))
        if not lines:
            raise ValueError(f"{path}: no columns to parse")
        header, body = lines[0], lines[1:]
        for i, line in enumerate(body):
            if len(line) != len(header):
                raise ValueError(f"{path}:{i + 2}: {len(line)} fields, expected "
                                 f"{len(header)}")
        return cls({c: _parse([line[j] for line in body]) for j, c in enumerate(header)})

    def to_csv(self, path: str) -> None:
        """``to_csv(index=False)``: each field as ``features._csv_field``
        writes it, through the csv module's quoting, as pandas writes."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.data)
            w.writerows(zip(*(_strings(c) for c in self.data.values())))

    @property
    def columns(self) -> list[str]:
        return list(self.data)

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __setitem__(self, name: str, values) -> None:
        """Set a column; a scalar fills every row (int → int64, str → object)."""
        if isinstance(values, str):
            col = np.empty(len(self), dtype=object)
            col[:] = values
            values = col
        elif np.ndim(values) == 0:
            values = np.full(len(self), values,
                             dtype=np.int64 if isinstance(values, int) else None)
        values = np.asarray(values)
        if self.data and len(values) != len(self):
            raise ValueError(f"column {name!r}: {len(values)} rows, expected {len(self)}")
        self.data[name] = values

    def copy(self) -> "Table":
        return Table({c: v.copy() for c, v in self.data.items()})

    def take(self, rows) -> "Table":
        """The rows that an index array, slice or boolean mask selects."""
        return Table({c: v[rows] for c, v in self.data.items()})

    def drop(self, names) -> "Table":
        names = set(names)
        return Table({c: v for c, v in self.data.items() if c not in names})

    def rename(self, mapping: dict) -> "Table":
        return Table({mapping.get(c, c): v for c, v in self.data.items()})

    def sort_values(self, by) -> "Table":
        """``DataFrame.sort_values(by)``.  One key: numpy's quicksort of the
        key (``nargsort``, not stable).  Several: a stable sort by each
        key's sorted codes (``lexsort_indexer``), so tied rows keep their
        order."""
        if isinstance(by, str) or len(by) == 1:
            key = self.data[by if isinstance(by, str) else by[0]]
            if key.dtype == object:
                raise TypeError("a one-key sort takes a numeric column")
            nan = np.isnan(key) if key.dtype.kind == "f" else np.zeros(len(key), bool)
            idx = np.arange(len(key))
            order = np.concatenate([idx[~nan][key[~nan].argsort(kind="quicksort")],
                                    idx[nan]])
            return self.take(order)
        codes = [np.unique(self.data[k], return_inverse=True)[1] for k in by]
        return self.take(np.lexsort(codes[::-1]))

    def keys(self, names) -> list[tuple]:
        """Each row's values in ``names`` as a tuple (a MultiIndex's entries)."""
        return list(zip(*(self.data[c].tolist() for c in names)))


def _common(parts: list, n_rows: list) -> np.ndarray:
    """One concatenated column; ``None`` parts are missing (NaN rows).  An
    int or bool column that receives NaN, or meets another type, is
    promoted as pandas promotes it: int + float or NaN → float64, bool or
    strings + anything else → object."""
    present = [p for p in parts if p is not None]
    kinds = {p.dtype.kind for p in present}
    missing = len(present) < len(parts)
    if kinds == {"i"} and not missing:
        dtype = np.int64
    elif kinds == {"b"} and not missing:
        dtype = bool
    elif kinds <= {"i", "f"}:
        dtype = np.float64
    else:
        dtype = object
    filled = [np.full(n, np.nan, dtype=dtype) if p is None else p.astype(dtype)
              for p, n in zip(parts, n_rows)]
    return np.concatenate(filled) if filled else np.empty(0, dtype=dtype)


def concat(tables: list) -> Table:
    """``pd.concat(tables, ignore_index=True)``: the union of the columns in
    order of first appearance, a column that a table lacks as NaN there."""
    names: dict = {}
    for t in tables:
        names.update(dict.fromkeys(t.columns))
    n_rows = [len(t) for t in tables]
    return Table({c: _common([t.data.get(c) for t in tables], n_rows) for c in names})
