"""Shared CLI plumbing (the serving subset of :mod:`toad_tpu.cli.common`)."""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def parse_sex(value) -> int:
    """F/M/0/1 (any case, also 'female'/'male', int- or float-coded) -> 0/1."""
    m = {"f": 0, "m": 1, "female": 0, "male": 1, "0": 0, "1": 1, "0.0": 0, "1.0": 1}
    key = str(value).strip().lower()
    if key not in m:
        raise ValueError(f"sex must be F/M/0/1, got {value!r}")
    return m[key]


def add_buckets_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--buckets", type=str, default=None, metavar="LIST",
        help="bucket ladder override: comma-separated bag lengths (positive integers; "
        "the CUDA kernel masks ragged row tiles, so no multiple is required)",
    )


def resolve_buckets(value: str | None) -> tuple[int, ...] | None:
    """--buckets: None (keep the default ladder) or an explicit comma list,
    sorted and validated."""
    if not value:
        return None
    if value.strip().lower() == "auto":
        raise SystemExit("--buckets auto needs a dataset scan, which this package does not port yet; give a list")
    try:
        ladder = tuple(int(x) for x in value.split(","))
    except ValueError:
        raise SystemExit(f"--buckets {value!r}: expected comma-separated integers") from None
    bad = [b for b in ladder if b <= 0]
    if bad:
        raise SystemExit(f"--buckets {bad} must be positive")
    return tuple(sorted(ladder))


def add_temperature_from_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--temperature_from", type=str, default=None, metavar="JSON",
        help="read the serving temperature from a calibration JSON written by "
        "evaluate --calibrate (fold_<k>_calibration.json); conflicts with an "
        "explicit --temperature",
    )


def resolve_temperature(temperature: float, temperature_from: str | os.PathLike | None) -> float:
    """The serving temperature: explicit --temperature, or the 'temperature'
    key of an evaluate --calibrate artifact via --temperature_from."""
    if temperature_from is None:
        return temperature
    if temperature != 1.0:
        raise SystemExit("give --temperature OR --temperature_from, not both")
    path = os.fspath(temperature_from)
    try:
        obj = json.loads(Path(path).read_text())
    except FileNotFoundError:
        raise SystemExit(f"--temperature_from: {path} does not exist") from None
    except json.JSONDecodeError as e:
        raise SystemExit(f"--temperature_from: {path} is not valid JSON ({e})") from None
    if "temperature" not in obj:
        raise SystemExit(f"--temperature_from: no 'temperature' key in {path} (keys: {sorted(obj)})")
    t = float(obj["temperature"])
    print(f"temperature {t:.4f} from {path}", file=sys.stderr)
    return t
