"""``python -m toad_tpu_torch report``: aggregate k-fold results.

Counterpart of :mod:`toad_tpu.cli.report`. The reference leaves per-fold
rows in ``summary.csv`` for hand analysis (``main_mtl_concat.py:64-78``);
this prints (and with ``--out`` saves) the cross-fold aggregate: mean ± std
(and min/max) per metric over a training results dir or an eval-results dir,
with the bootstrap CI columns and the per-fold calibration temperatures when
present. The last line of stdout is one JSON object, for scripting. The
summary is read with the stdlib ``csv`` module the way pandas reads it: a
column is a metric when every cell that is not empty parses as a number, an
empty cell is a missing value, and the index column and ``folds`` are left out.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from toad_tpu_torch.data.wsi_dataset import read_csv_columns
from toad_tpu_torch.utils.io import write_columns_csv

# the cells pandas' read_csv takes for a missing value
_NA_CELLS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch report", description="TOAD k-fold result aggregation")
    p.add_argument("--dir", type=str, required=True,
                   help="results/{exp}_s{seed} (train) or eval_results/EVAL_{code} (eval)")
    p.add_argument("--out", type=str, default=None, help="write the aggregate as CSV here")
    return p


def _find_summary(d: Path) -> Path:
    cands = sorted(d.glob("summary*.csv"))
    if not cands:
        raise FileNotFoundError(f"no summary*.csv in {d} (train or eval output dir expected)")
    full = d / "summary.csv"
    return full if full.exists() else cands[0]


def numeric_column(cells: list[str]) -> np.ndarray | None:
    """The column as float64 with NaN for missing cells, or None when some
    cell is neither a number nor missing (a column pandas would read as
    strings, like ``folds`` with an ``ensemble`` row)."""
    out = np.full(len(cells), np.nan)
    for i, cell in enumerate(cells):
        if cell.strip() in _NA_CELLS:
            continue
        try:
            out[i] = float(cell)
        except ValueError:
            return None
    return out


def _stats(name: str, v: np.ndarray) -> dict:
    return {"metric": name, "mean": float(v.mean()), "std": float(v.std(ddof=1)) if len(v) > 1 else 0.0,
            "min": float(v.min()), "max": float(v.max()), "n": int(len(v))}


def aggregate(d: str | Path) -> tuple[list[dict], dict]:
    """(one aggregate row per metric, flat dict for the JSON line)."""
    d = Path(d)
    cols = read_csv_columns(_find_summary(d))
    n_rows = len(next(iter(cols.values()), []))
    rows, flat = [], {"n_folds": int(n_rows), "dir": str(d)}
    for name, cells in cols.items():
        if name in ("", "folds") or name.startswith("Unnamed"):
            continue
        v = numeric_column(cells)
        if v is None:
            continue
        v = v[np.isfinite(v)]
        if len(v) == 0:
            continue
        rows.append(_stats(name, v))
        flat[f"{name}_mean"] = rows[-1]["mean"]
    # per-fold calibration temperatures, if `eval --calibrate` ran
    temps = []
    for f in sorted(d.glob("fold_*_calibration.json")):
        try:
            temps.append(float(json.loads(f.read_text())["temperature"]))
        except (OSError, ValueError, KeyError, TypeError):
            pass  # an unreadable artefact is left out of the aggregate
    if temps:
        rows.append(_stats("calibration_temperature", np.asarray(temps)))
        flat["calibration_temperature_mean"] = rows[-1]["mean"]
    return rows, flat


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    agg, flat = aggregate(args.dir)
    if not agg:
        raise SystemExit(f"no numeric metric column in {_find_summary(Path(args.dir))}")
    width = max(len(r["metric"]) for r in agg)
    print(f"{'metric':<{width}}  {'mean':>8}  {'std':>8}  {'min':>8}  {'max':>8}  n")
    for r in agg:
        print(f"{r['metric']:<{width}}  {r['mean']:>8.4f}  {r['std']:>8.4f}  "
              f"{r['min']:>8.4f}  {r['max']:>8.4f}  {r['n']}")
    if args.out:
        write_columns_csv(args.out, {k: [r[k] for r in agg] for k in ("metric", "mean", "std", "min", "max", "n")})
        print(f"wrote {args.out}")
    print(json.dumps(flat))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
