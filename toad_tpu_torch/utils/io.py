"""Results persistence: pickled dicts, settings snapshots and result tables.

Parity with the reference's ``utils/file_utils.py:4-13`` (save_pkl/load_pkl)
and the settings echo it writes to ``experiment_{exp_code}.txt``
(``main_mtl_concat.py:178-180``). The CSV writers produce, without pandas,
the bytes ``DataFrame.to_csv`` writes for the same table, so that either
package reads the other's result files.
"""

from __future__ import annotations

import csv
import os
import pickle
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np


def save_pkl(filename: str | os.PathLike, obj: Any) -> None:
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    with open(filename, "wb") as f:
        pickle.dump(obj, f)


def load_pkl(filename: str | os.PathLike) -> Any:
    with open(filename, "rb") as f:
        return pickle.load(f)


def write_settings(path: str | os.PathLike, settings: dict[str, Any]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        print(settings, file=f)


def _cells(values) -> list[str]:
    """One column as pandas writes it: a float as the shortest string that
    reads back as the same value of its own width (float32 columns stay
    short), NaN and None as an empty cell, anything else through ``str``."""
    arr = values if isinstance(values, np.ndarray) else np.array(list(values), dtype=object)
    if arr.dtype.kind == "f":
        text = arr.astype(str)
        text[np.isnan(arr)] = ""
        return text.tolist()
    if arr.dtype.kind == "O":
        return ["" if v is None or (isinstance(v, (float, np.floating)) and v != v) else str(v) for v in arr]
    return arr.astype(str).tolist()


def write_columns_csv(path: str | os.PathLike, columns: Mapping[str, Any], index: Sequence | None = None) -> None:
    """``pd.DataFrame(columns).to_csv(path, index=False)``, or with ``index``
    given ``pd.DataFrame(columns, index=index).to_csv(path)``: the index goes
    into an unnamed first column."""
    cols = [_cells(v) for v in columns.values()]
    header = list(columns)
    if index is not None:
        cols.insert(0, _cells(index))
        header.insert(0, "")
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")  # pandas: minimal quoting, "\n" line ends
        w.writerow(header)
        w.writerows(zip(*cols))


def write_rows_csv(path: str | os.PathLike, rows: Sequence[Mapping[str, Any]], columns: Sequence[str] | None = None,
                   index: bool = True) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=index)``: with ``index`` a
    running index in an unnamed first column, then one column per key in
    first-seen order (or ``columns``); a key a row lacks is an empty cell."""
    if columns is None:
        columns = list(dict.fromkeys(k for row in rows for k in row))
    write_columns_csv(path, {c: [row.get(c) for row in rows] for c in columns},
                      index=range(len(rows)) if index else None)
