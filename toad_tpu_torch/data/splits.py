"""Stratified k-fold split generation and the three split-file formats.

PyTorch-side counterpart of :mod:`toad_tpu.data.splits`, without pandas.
Reproduces the observable behavior of the reference's split machinery:

- sampling semantics of ``generate_split`` (``utils/utils.py:87-126``): a
  single seed drives k successive splits; per class, val ids are drawn
  without replacement, then test ids from the remainder, and the (sorted)
  rest becomes train, optionally subsampled by ``label_frac``;
- patient-stratified expansion and held-out test sampling;
- the file formats written by ``save_splits``: columnar ``splits_i.csv``
  (ragged columns under an index column, empty cells where a column ended),
  one-hot ``splits_i_bool.csv``, and the per-class count
  ``splits_i_descriptor.csv``, byte for byte as pandas writes them, so that
  either package reads the other's files.

The draws come from an explicit ``np.random.RandomState(seed)`` in the
reference's order, so both packages (and the reference) draw the same folds.
"""

from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np

from toad_tpu_torch.data.wsi_dataset import read_csv_columns
from toad_tpu_torch.utils import invert_labels


@dataclass(frozen=True)
class SplitSpec:
    """One fold's (train, val, test) id arrays (slide- or patient-level)."""

    train: np.ndarray
    val: np.ndarray
    test: np.ndarray

    def validate_disjoint(self) -> None:
        if len(np.intersect1d(self.train, self.test)):
            raise ValueError("train/test overlap")
        if len(np.intersect1d(self.train, self.val)):
            raise ValueError("train/val overlap")
        if len(np.intersect1d(self.val, self.test)):
            raise ValueError("val/test overlap")


def generate_splits(
    cls_ids: Sequence[np.ndarray],
    val_num: Sequence[int],
    test_num: Sequence[int],
    samples: int,
    n_splits: int = 5,
    seed: int = 7,
    label_frac: float = 1.0,
    custom_test_ids: np.ndarray | None = None,
):
    """Yield ``n_splits`` :class:`SplitSpec`s with the reference's draw order."""
    indices = np.arange(samples).astype(int)
    if custom_test_ids is not None:
        custom_test_ids = np.asarray(custom_test_ids, dtype=int)
        indices = np.setdiff1d(indices, custom_test_ids)

    rng = np.random.RandomState(seed)
    for _ in range(n_splits):
        all_val: list[np.ndarray] = []
        all_test: list[np.ndarray] = []
        train: list[np.ndarray] = []

        if custom_test_ids is not None:
            all_test.append(custom_test_ids)

        for c in range(len(val_num)):
            possible = np.intersect1d(cls_ids[c], indices)
            remaining = possible

            if val_num[c] > 0:
                val_ids = rng.choice(possible, val_num[c], replace=False)
                remaining = np.setdiff1d(possible, val_ids)
                all_val.append(val_ids)

            if custom_test_ids is None and test_num[c] > 0:
                test_ids = rng.choice(remaining, test_num[c], replace=False)
                remaining = np.setdiff1d(remaining, test_ids)
                all_test.append(test_ids)

            if label_frac == 1:
                train.append(remaining)
            else:
                n = math.ceil(len(remaining) * label_frac)
                train.append(remaining[:n])

        yield SplitSpec(
            train=np.concatenate(train) if train else np.array([], int),
            val=np.concatenate(all_val) if all_val else np.array([], int),
            test=np.concatenate(all_test) if all_test else np.array([], int),
        )


def sample_held_out(cls_ids: Sequence[np.ndarray], test_num: Sequence[int], seed: int) -> np.ndarray:
    """Fixed held-out test ids, one draw per class."""
    rng = np.random.RandomState(seed)
    ids = [rng.choice(cls_ids[c], test_num[c], replace=False) for c in range(len(test_num))]
    return np.concatenate(ids) if ids else np.array([], int)


def expand_patient_split(spec: SplitSpec, patient_ids: np.ndarray, case_ids: np.ndarray) -> SplitSpec:
    """Map patient-level id splits to slide-level indices."""

    def expand(ids: np.ndarray) -> np.ndarray:
        out: list[np.ndarray] = []
        for idx in ids:
            out.append(np.where(case_ids == patient_ids[idx])[0])
        return np.concatenate(out) if out else np.array([], int)

    return SplitSpec(train=expand(spec.train), val=expand(spec.val), test=expand(spec.test))


# -- file formats -------------------------------------------------------------


def _write_rows(filename: str | os.PathLike, rows) -> None:
    # pandas' to_csv: minimal quoting, "\n" line ends
    with open(filename, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)


def save_split_columnar(slide_ids_by_split: dict[str, Sequence[str]], filename: str | os.PathLike) -> None:
    """Ragged columnar format: an index column, then columns train/val/test
    of slide ids, a column that ended leaving empty cells."""
    keys = list(slide_ids_by_split.keys())
    cols = [[str(v) for v in slide_ids_by_split[k]] for k in keys]
    n = max((len(c) for c in cols), default=0)
    rows = [["", *keys]]
    rows += [[str(i), *(c[i] if i < len(c) else "" for c in cols)] for i in range(n)]
    _write_rows(filename, rows)


def save_split_boolean(slide_ids_by_split: dict[str, Sequence[str]], filename: str | os.PathLike) -> None:
    """One-hot membership format: slide ids in the index column, a True/False
    column per split."""
    keys = list(slide_ids_by_split.keys())
    rows = [["", *keys]]
    for j, k in enumerate(keys):
        rows += [[str(v), *("True" if i == j else "False" for i in range(len(keys)))] for v in slide_ids_by_split[k]]
    _write_rows(filename, rows)


@dataclass(frozen=True)
class SplitDescriptor:
    """Per-class sample counts per split, the tasks' tables stacked."""

    index: tuple[str, ...]  # class names, task after task
    columns: tuple[str, ...]  # train, val, test
    counts: np.ndarray  # [len(index), 3] int64

    def to_csv(self, filename: str | os.PathLike) -> None:
        rows = [["", *self.columns]]
        rows += [[name, *map(str, row)] for name, row in zip(self.index, self.counts.tolist())]
        _write_rows(filename, rows)


def split_descriptor(
    spec: SplitSpec,
    getlabel,
    label_dicts: Sequence[dict[str, int]],
    num_classes: Sequence[int],
) -> SplitDescriptor:
    """Per-class sample counts per split, stacked over tasks (reference
    ``test_split_gen(return_descriptor=True)``)."""
    spec.validate_disjoint()
    index: list[str] = []
    blocks = []
    for task in range(len(label_dicts)):
        inv = invert_labels(label_dicts[task])
        index += [inv[i] for i in range(num_classes[task])]
        blocks.append(np.stack(
            [np.bincount(getlabel(ids, task), minlength=num_classes[task]) for ids in (spec.train, spec.val, spec.test)],
            axis=1,
        ).astype(np.int64))
    return SplitDescriptor(tuple(index), ("train", "val", "test"), np.concatenate(blocks, axis=0))


# both bool-format writers (this one and the reference's df.astype(bool).to_csv)
# emit literal True/False, never 0/1, which could be real numeric slide ids
_BOOL_TOKENS = {"True", "False", "TRUE", "FALSE", "true", "false"}


def load_split_csv(csv_path: str | os.PathLike) -> dict[str, list[str]]:
    """Read a split file into {split: [slide ids]}: either the columnar
    ragged format or the one-hot ``splits_i_bool.csv`` membership format
    (detected by all-boolean split columns with the ids in the index
    column). Every cell is read as a string, so an all-numeric slide id
    stays ``201`` beside the empty cells of a shorter column."""
    cols = read_csv_columns(csv_path)
    present = [k for k in ("train", "val", "test") if k in cols]
    if not present:
        raise ValueError(f"{csv_path} has none of train/val/test columns")
    cells = {v for k in present for v in cols[k] if v != ""}
    if cells and cells <= _BOOL_TOKENS and len(cols) > len(present):
        ids = next(iter(cols.values()))  # the index column holds the slide ids
        truthy = {"True", "TRUE", "true"}
        return {k: [i for i, v in zip(ids, cols[k]) if v in truthy] for k in present}
    return {k: [v for v in cols[k] if v != ""] for k in present}


def split_file(split_dir: str | os.PathLike, fold: int, kind: str = "") -> Path:
    """Conventional split filenames: splits_{i}[_bool|_descriptor].csv."""
    suffix = f"_{kind}" if kind else ""
    return Path(split_dir) / f"splits_{fold}{suffix}.csv"
