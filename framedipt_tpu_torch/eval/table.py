"""Tables as lists of row dicts, with the CSV text pandas writes for them.

The evaluation CLI collects its metrics as one dict a row. A row may lack a
column that another row has (a loop of another length has other
per-residue columns); the cell is then missing, as None is. ``write_csv``
writes what ``pandas.DataFrame(rows).to_csv(path, index=False)`` writes,
column by column:

- the columns in order of first appearance over the rows;
- a column of ints only, none missing: the ints;
- a column of numpy float32s only: each as its shortest float32 repr
  (``0.1``), NaN empty;
- a column of numbers otherwise (ints and floats, or ints with a missing
  cell): each as a float64, written as its shortest repr (a float32 is
  widened first: ``0.10000000149011612``), NaN and missing cells empty;
- any other column: ``str`` of each value, None, NaN and missing empty.

``read_csv`` reads such a file back with the types pandas' ``read_csv``
gives its columns (see there).
"""
from __future__ import annotations

import csv
import math
import numbers
import pathlib

import numpy as np


def columns(rows: list[dict]) -> list[str]:
    """Every column of ``rows``, in order of first appearance."""
    seen: dict[str, None] = {}
    for row in rows:
        for key in row:
            seen.setdefault(key, None)
    return list(seen)


def _missing(v) -> bool:
    return v is None or (isinstance(v, float | np.floating) and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, numbers.Number) and not isinstance(v, bool | np.bool_ | complex)


def column(rows: list[dict], name: str) -> np.ndarray:
    """Column ``name`` as float64, NaN where a row lacks it or holds None."""
    return np.asarray([np.nan if _missing(r.get(name)) else r[name] for r in rows], np.float64)


def present(rows: list[dict], name: str) -> np.ndarray:
    """The non-NaN values of column ``name`` (pandas' ``dropna``)."""
    values = column(rows, name)
    return values[~np.isnan(values)]


def _column_cells(values: list) -> list[str]:
    present = [v for v in values if not _missing(v)]
    if values and all(isinstance(v, np.float32) for v in values):
        return ["" if _missing(v) else str(v) for v in values]
    if present and all(_is_number(v) for v in present):
        if len(present) == len(values) and all(isinstance(v, numbers.Integral) for v in present):
            return [str(int(v)) for v in values]
        return ["" if _missing(v) else repr(float(v)) for v in values]
    return ["" if _missing(v) else str(v) for v in values]


def write_csv(rows: list[dict], path: str | pathlib.Path) -> None:
    """Write ``rows`` as pandas' ``DataFrame(rows).to_csv(path,
    index=False)`` would (see the module docstring)."""
    names = columns(rows)
    cells = [_column_cells([r.get(name) for r in rows]) for name in names]
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        for i in range(len(rows)):
            writer.writerow([c[i] for c in cells])


# The cells pandas' read_csv takes for missing values by default.
NA_CELLS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _parsed_column(cells: list[str]) -> list:
    """A column's cells as pandas' read_csv types them: ints when every cell
    is an int, floats (NaN where missing) when every present cell is a
    number, else strings (None where missing)."""
    present = [c for c in cells if c not in NA_CELLS]
    for cast in (int, float):
        try:
            values = [cast(c) for c in present]
        except ValueError:
            continue
        if cast is int and len(present) < len(cells):
            continue  # a missing cell makes an int column float
        it = iter(values)
        return [math.nan if c in NA_CELLS else next(it) for c in cells]
    return [None if c in NA_CELLS else c for c in cells]


def read_csv(path: str | pathlib.Path, delimiter: str = ",",
             names: list[str] | None = None) -> list[dict]:
    """The rows of a CSV file (the first line its header, unless ``names``
    are given), each column typed as pandas' ``read_csv`` types it: ints,
    floats with NaN for missing cells, or strings with None."""
    with open(path, newline="", encoding="utf-8") as f:
        lines = list(csv.reader(f, delimiter=delimiter))
    if names is None:
        names, lines = (lines[0], lines[1:]) if lines else ([], [])
    columns = {name: _parsed_column([line[i] if i < len(line) else "" for line in lines])
               for i, name in enumerate(names)}
    return [{name: columns[name][r] for name in names} for r in range(len(lines))]
