"""WSI feature-bag dataset: CSV ingest, label mapping, splits, bag access.

PyTorch-side counterpart of :mod:`toad_tpu.data.wsi_dataset`, without
pandas: the manifest is read with the stdlib ``csv`` module into columns of
strings. Two of pandas' reading habits are kept, so that both packages see
one manifest alike: a column whose every cell is an integer is a column of
integers (label columns then hold codes, and an id like ``0201`` reads as
``201``), and an empty cell is a missing value.

- **Loud vocabulary validation.** Every label column is validated against
  its dict up front with a readable error; no row is dropped silently.
- **Arrays, not a torch ``Dataset``.** Consumers get numpy label/site/sex
  arrays and slide ids; bag IO is a pure function
  (:mod:`toad_tpu_torch.data.bags`), so batching and prefetch
  (:mod:`toad_tpu_torch.data.batching`) run in threads.
"""

from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Mapping, Sequence

import numpy as np

from toad_tpu_torch.config import TaskConfig
from toad_tpu_torch.data.bags import bag_path, load_bag
from toad_tpu_torch.utils import invert_labels

_INT = re.compile(r"^[+-]?\d+$")


@dataclass(frozen=True)
class SlideRecord:
    """One slide's metadata row (labels already mapped to ints)."""

    slide_id: str
    case_id: str
    label: int
    site: int
    sex: int
    source: str | None = None


class LabelVocabularyError(ValueError):
    """Raised when CSV label values don't match the task's label dictionary."""


def read_csv_columns(path: str | os.PathLike) -> dict[str, list[str]]:
    """A CSV file as {column: [cell strings]}, in file order; an unnamed
    first column (an index written by pandas) is keyed ``""``."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is None:
            return {}
        cols: dict[str, list[str]] = {name: [] for name in header}
        for row in reader:
            if not row:
                continue
            for j, name in enumerate(header):
                cols[name].append(row[j] if j < len(row) else "")
    return cols


def is_integer_column(values: Sequence[str]) -> bool:
    """Whether pandas would read this column as integers: no cell empty, all digits."""
    return len(values) > 0 and all(_INT.match(v) for v in values)


def id_strings(values: Sequence[str]) -> np.ndarray:
    """An id column as the strings ``pd.read_csv(...).astype(str)`` gives: an
    all-integer column loses leading zeros and signs of ``+``."""
    if is_integer_column(values):
        values = [str(int(v)) for v in values]
    return np.array(list(values), dtype=object).astype(str) if len(values) else np.array([], dtype=str)


def _map_column(values: Sequence[str], col: str, mapping: Mapping[str, int], task_name: str) -> np.ndarray:
    # Accept pre-coded integer columns as-is if they land in the dict's range.
    if is_integer_column(values):
        codes = np.array([int(v) for v in values])
        valid = set(mapping.values())
        bad = sorted(set(codes.tolist()) - valid)
        if bad:
            raise LabelVocabularyError(
                f"task {task_name!r}: column {col!r} has integer codes {bad} "
                f"outside the label dict range {sorted(valid)}"
            )
        return codes.astype(np.int32)
    unknown = sorted({v for v in values if v not in mapping})
    if unknown:
        raise LabelVocabularyError(
            f"task {task_name!r}: column {col!r} contains values not in the label "
            f"dictionary: {unknown}. Known keys: {sorted(mapping.keys())}. "
            f"Fix the task JSON or the CSV: refusing to silently drop rows."
        )
    return np.array([mapping[v] for v in values], dtype=np.int32)


def vote_label(labels: np.ndarray, voting: str) -> int:
    """Patient-level label vote (reference ``patient_data_prep``). The one
    definition used by dataset bookkeeping and patient concat bags."""
    if voting == "max":
        return int(labels.max())
    if voting == "maj":
        return int(np.bincount(labels).argmax())
    raise NotImplementedError(f"patient_voting={voting!r}")


def inverse_frequency_weights(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """Per-sample inverse-class-frequency weights for balanced sampling."""
    n = float(len(labels))
    counts = np.bincount(labels, minlength=n_classes).astype(np.float64)
    with np.errstate(divide="ignore"):
        per_class = np.where(counts > 0, n / counts, 0.0)
    return per_class[labels]


class WSIBagDataset:
    """Slide-level dataset over a CSV manifest plus on-disk feature bags.

    ``data_dir`` may be a single directory or a ``{source: dir}`` mapping
    routed by the CSV's ``source`` column. ``frame`` holds the manifest's
    columns (after filtering and shuffling) as lists of cell strings.
    """

    def __init__(
        self,
        task: TaskConfig,
        csv_path: str | os.PathLike | None = None,
        data_dir: str | Mapping[str, str] | None = None,
        *,
        shuffle: bool = False,
        seed: int = 7,
        filter_dict: Mapping[str, Sequence] | None = None,
        use_h5: bool = False,
        print_info: bool = False,
    ) -> None:
        self.task = task
        self.seed = seed
        self.data_dir = data_dir
        self.use_h5 = use_h5
        self.label_cols = list(task.label_cols)
        self.num_classes = list(task.n_classes)

        path = Path(csv_path if csv_path is not None else task.csv_path)
        if not path.exists():
            hint = ""
            if not path.is_absolute():
                hint = (
                    f" (relative paths resolve against the current directory,"
                    f" {Path.cwd()}; pass an absolute --csv_path, or generate"
                    f" fixtures with `python -m toad_tpu_torch make-dummy`)"
                )
            raise FileNotFoundError(f"dataset csv not found: {path}{hint}")
        cols = read_csv_columns(path)

        required = {"slide_id", "case_id", *self.label_cols}
        missing = sorted(required - set(cols))
        if missing:
            raise LabelVocabularyError(f"csv {path} missing required columns: {missing}")

        n = len(cols["slide_id"])
        keep = np.ones(n, dtype=bool)
        if filter_dict:
            for key, vals in filter_dict.items():
                wanted = {str(v) for v in vals}
                keep &= np.array([v in wanted for v in id_strings(cols[key])], dtype=bool)
        if task.ignore:
            ignored = set(task.ignore)
            keep &= np.array([v not in ignored for v in cols[self.label_cols[0]]], dtype=bool)
        order = np.where(keep)[0]
        if shuffle:
            order = order[np.random.RandomState(seed).permutation(len(order))]
        cols = {k: [v[i] for i in order] for k, v in cols.items()}

        # Map every label column with loud validation.
        mapped = {}
        for col, ldict in zip(self.label_cols, task.label_dicts):
            mapped[col] = _map_column(cols[col], col, ldict, task.name)

        self.frame = cols
        n = len(order)
        self.slide_ids = id_strings(cols["slide_id"])
        self.case_ids = id_strings(cols["case_id"])
        self.labels = mapped[self.label_cols[0]]
        self.sites = mapped[self.label_cols[1]] if len(self.label_cols) > 1 else np.zeros(n, np.int32)
        self.sexes = mapped[self.label_cols[2]] if len(self.label_cols) > 2 else np.zeros(n, np.int32)
        self.sources = id_strings(cols["source"]) if "source" in cols else None

        self._patient_data_prep(task.patient_voting)
        self._cls_ids_prep()

        if print_info:
            self.summarize()

    # -- class/patient bookkeeping ------------------------------------------

    def _patient_data_prep(self, voting: str) -> None:
        patients, inverse = np.unique(self.case_ids, return_inverse=True)
        patient_labels = np.zeros(len(patients), dtype=np.int32)
        for p in range(len(patients)):
            labels = self.labels[inverse == p]
            if len(labels) == 0:
                raise ValueError(f"patient {patients[p]} has no slides")
            patient_labels[p] = vote_label(labels, voting)
        self.patient_ids = patients
        self.patient_labels = patient_labels

    def _cls_ids_prep(self) -> None:
        n0 = self.num_classes[0]
        self.patient_cls_ids = [np.where(self.patient_labels == c)[0] for c in range(n0)]
        self.slide_cls_ids = [np.where(self.labels == c)[0] for c in range(n0)]

    # -- python protocol -----------------------------------------------------

    def __len__(self) -> int:
        if self.task.patient_strat:
            return len(self.patient_ids)
        return len(self.slide_ids)

    @property
    def n_slides(self) -> int:
        return len(self.slide_ids)

    def record(self, idx: int) -> SlideRecord:
        return SlideRecord(
            slide_id=str(self.slide_ids[idx]),
            case_id=str(self.case_ids[idx]),
            label=int(self.labels[idx]),
            site=int(self.sites[idx]),
            sex=int(self.sexes[idx]),
            source=None if self.sources is None else str(self.sources[idx]),
        )

    def getlabel(self, ids, task: int = 0) -> np.ndarray:
        """Labels for slide indices ``ids`` in task ``task``."""
        arrs = [self.labels, self.sites, self.sexes]
        return np.asarray(arrs[task])[np.asarray(ids, dtype=np.int64)]

    # -- bag IO ---------------------------------------------------------------

    def _dir_for(self, idx: int) -> str:
        if isinstance(self.data_dir, Mapping):
            if self.sources is None:
                raise ValueError("data_dir is a mapping but csv has no 'source' column")
            return str(self.data_dir[self.sources[idx]])
        if self.data_dir is None:
            raise ValueError("dataset constructed without data_dir; bags unavailable")
        return str(self.data_dir)

    def bag_file(self, idx: int) -> Path:
        return bag_path(self._dir_for(idx), str(self.slide_ids[idx]), use_h5=self.use_h5)

    def load_bag(self, idx: int, with_coords: bool = False):
        """Load slide ``idx``'s [N, D] feature bag (and coords where stored)."""
        return load_bag(self.bag_file(idx), with_coords=with_coords)

    # -- split application ------------------------------------------------------

    def subset(self, ids: Iterable[int]) -> "WSIBagSplit":
        ids = np.asarray(list(ids), dtype=np.int64)
        return WSIBagSplit(self, ids)

    def subset_by_slide_ids(self, slide_ids: Sequence[str]) -> "WSIBagSplit":
        wanted = set(map(str, slide_ids))
        ids = np.where(np.isin(self.slide_ids, list(wanted)))[0]
        found = {str(self.slide_ids[i]) for i in ids}
        lost = sorted(wanted - found)
        if lost:
            # a silent intersection would train or evaluate on a skewed subset
            raise LabelVocabularyError(
                f"{len(lost)} split slide id(s) not in the dataset csv "
                f"(first few: {lost[:5]}): split file and manifest disagree"
            )
        return self.subset(ids)

    def return_splits_from_csv(self, csv_path: str | os.PathLike):
        """(train, val, test) views from a columnar split file."""
        from toad_tpu_torch.data.splits import load_split_csv

        cols = load_split_csv(csv_path)
        out = []
        for key in ("train", "val", "test"):
            names = cols.get(key, [])
            out.append(self.subset_by_slide_ids(names) if len(names) else None)
        return tuple(out)

    def summarize(self) -> None:
        print(f"task: {self.task.name} | {self.n_slides} slides, {len(self.patient_ids)} patients")
        for t, (col, ldict) in enumerate(zip(self.label_cols, self.task.label_dicts)):
            print(f"task {t}: column={col!r} classes={self.num_classes[t]}")
            inv = invert_labels(ldict)
            arr = [self.labels, self.sites, self.sexes][t]
            binc = np.bincount(arr, minlength=self.num_classes[t])
            for c, n in enumerate(binc):
                print(f"  class {c} ({inv.get(c, '?')}): {n} slides")


class WSIBagSplit:
    """A split view over a parent :class:`WSIBagDataset`, sharing bag IO."""

    def __init__(self, parent: WSIBagDataset, ids: np.ndarray) -> None:
        self.parent = parent
        self.ids = np.asarray(ids, dtype=np.int64)
        self.task = parent.task
        self.num_classes = parent.num_classes
        self.slide_ids = parent.slide_ids[self.ids]
        self.case_ids = parent.case_ids[self.ids]
        self.labels = parent.labels[self.ids]
        self.sites = parent.sites[self.ids]
        self.sexes = parent.sexes[self.ids]
        n0 = self.num_classes[0]
        self.slide_cls_ids = [np.where(self.labels == c)[0] for c in range(n0)]

    def __len__(self) -> int:
        return len(self.ids)

    def getlabel(self, ids, task: int = 0) -> np.ndarray:
        arrs = [self.labels, self.sites, self.sexes]
        return np.asarray(arrs[task])[np.asarray(ids, dtype=np.int64)]

    def record(self, i: int) -> SlideRecord:
        return self.parent.record(int(self.ids[i]))

    def bag_file(self, i: int):
        return self.parent.bag_file(int(self.ids[i]))

    def load_bag(self, i: int, with_coords: bool = False):
        return self.parent.load_bag(int(self.ids[i]), with_coords=with_coords)

    def class_weights(self) -> np.ndarray:
        """See :func:`inverse_frequency_weights`."""
        return inverse_frequency_weights(self.labels, self.num_classes[0])


class PatientBagSplit:
    """Multi-slide-per-patient concat bags: every case's slides concatenate
    into one bag, so that MIL attends over all of a patient's tissue at once.

    Labels follow the task's ``patient_voting`` (max | maj); ``site`` is
    Metastatic if any slide is (max); ``sex`` is constant per patient (the
    first slide's value). Exposes the contract of :class:`WSIBagSplit`, so
    :class:`~toad_tpu_torch.data.batching.BagBatcher` and the trainer work
    unchanged; a patient bag spans several files, so it has ``groups`` and
    ``parent.bag_file`` instead of ``bag_file``.
    """

    def __init__(self, split: "WSIBagSplit", voting: str | None = None) -> None:
        self.parent = split
        self.task = split.task
        self.num_classes = split.num_classes
        cases, inverse = np.unique(split.case_ids, return_inverse=True)
        self.case_ids = cases
        self.slide_ids = cases  # bag identity = case id (split snapshots etc.)
        self.groups = [np.where(inverse == p)[0] for p in range(len(cases))]

        voting = voting or self.task.patient_voting
        labels = np.zeros(len(cases), np.int32)
        sites = np.zeros(len(cases), np.int32)
        sexes = np.zeros(len(cases), np.int32)
        for p, g in enumerate(self.groups):
            labels[p] = vote_label(split.labels[g], voting)
            sites[p] = split.sites[g].max()
            sexes[p] = split.sexes[g[0]]
        self.labels = labels
        self.sites = sites
        self.sexes = sexes
        n0 = self.num_classes[0]
        self.slide_cls_ids = [np.where(self.labels == c)[0] for c in range(n0)]

    def __len__(self) -> int:
        return len(self.groups)

    def slides_for(self, i: int) -> np.ndarray:
        """Slide ids making up patient bag i (order of concatenation)."""
        return self.parent.slide_ids[self.groups[i]]

    def load_bag(self, i: int, with_coords: bool = False):
        parts = [np.asarray(self.parent.load_bag(int(j)), np.float32) for j in self.groups[i]]
        feats = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        if with_coords:
            return feats, None  # coords are per-slide; meaningless across slides
        return feats

    def class_weights(self) -> np.ndarray:
        return inverse_frequency_weights(self.labels, self.num_classes[0])
