"""Synthetic fixtures: dummy manifest CSV and on-disk feature bags.

PyTorch-side counterpart of :mod:`toad_tpu.data.synthetic`, without pandas: a
manifest is a list of row dicts (``slide_id, case_id, label, sex, site``).
Both are generated deterministically from a seed with the same numpy draws
as the JAX package's, so the two write the same CSV and the same bags; bags
carry class-conditional means, so that training can learn on the fixture.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np

from toad_tpu_torch.config import TaskConfig

DEFAULT_ORIGINS = (
    "Lung", "Breast", "Colorectal", "Ovarian", "Pancreatobiliary", "Adrenal",
    "Skin", "Prostate", "Renal", "Bladder", "Esophagogastric", "Thyroid",
    "Head Neck", "Glioma", "Germ Cell", "Endometrial", "Cervix", "Liver",
)
MANIFEST_COLUMNS = ("slide_id", "case_id", "label", "sex", "site")


def make_dummy_manifest(
    n_patients: int = 400,
    max_slides_per_patient: int = 3,
    origins: tuple[str, ...] = DEFAULT_ORIGINS,
    seed: int = 0,
) -> list[dict[str, str]]:
    """Deterministic dummy manifest with every class populated."""
    rng = np.random.RandomState(seed)
    rows = []
    slide_counter = 0
    for p in range(n_patients):
        case_id = f"SYN-PATIENT_{p}"
        # round-robin the first 2 * len(origins) patients so every class exists
        label = origins[p % len(origins)] if p < 2 * len(origins) else origins[rng.randint(len(origins))]
        sex = "F" if rng.rand() < 0.5 else "M"
        n_slides = 1 + rng.randint(max_slides_per_patient)
        for _ in range(n_slides):
            site = "Primary" if rng.rand() < 0.66 else "Metastatic"
            rows.append({"slide_id": f"SYN-SLIDE_{slide_counter}", "case_id": case_id, "label": label,
                         "sex": sex, "site": site})
            slide_counter += 1
    return rows


def write_dummy_csv(path: str | os.PathLike, **kwargs) -> list[dict[str, str]]:
    rows = make_dummy_manifest(**kwargs)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=MANIFEST_COLUMNS, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    return rows


def dummy_task(csv_path: str, origins: tuple[str, ...] = DEFAULT_ORIGINS, name: str = "dummy_mtl_concat") -> TaskConfig:
    return TaskConfig(
        name=name,
        csv_path=str(csv_path),
        label_dicts=(
            {o: i for i, o in enumerate(origins)},
            {"Primary": 0, "Metastatic": 1},
            {"F": 0, "M": 1},
        ),
    )


def synth_bag(label: int, n_patches: int, dim: int = 1024, rng: np.random.RandomState | None = None) -> np.ndarray:
    """A learnable synthetic bag: noise + a sparse class-conditional signal
    on a small fraction of 'tumor' patches (MIL structure)."""
    rng = rng or np.random.RandomState(label * 7919 + n_patches)
    feats = rng.randn(n_patches, dim).astype(np.float32)
    n_signal = max(1, n_patches // 8)
    direction = np.zeros(dim, np.float32)
    direction[(label * 13) % dim : (label * 13) % dim + 16] = 2.5
    feats[:n_signal] += direction
    return feats


def class_direction_matrix(
    n_classes: int, dim: int, seed: int = 7, n_groups: int = 6, alpha: float = 0.65
) -> np.ndarray:
    """Confusable class signal directions for fixture-scale parity runs: each
    class direction blends a class-unique unit vector with a shared group
    vector, so that classes inside a group are partly confusable and the task
    does not saturate at AUC 1.0. Returns an ``[n_classes, dim]`` matrix of
    unit rows."""
    rng = np.random.RandomState(seed)
    u = rng.randn(n_classes, dim).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    g = rng.randn(n_groups, dim).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    d = alpha * u + (1.0 - alpha) * g[np.arange(n_classes) % n_groups]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d


def write_graded_bags(
    data_dir: str | os.PathLike,
    manifest: list[dict[str, str]],
    task: TaskConfig,
    n_patches_range: tuple[int, int] = (256, 512),
    dim: int = 1024,
    fmt: str = "npy",
    seed: int = 0,
    strength_range: tuple[float, float] = (0.25, 0.9),
    signal_frac_range: tuple[float, float] = (0.03, 0.09),
    blank_frac: float = 0.08,
    site_strength: float = 0.15,
) -> None:
    """Graded-difficulty bags for accuracy parity at fixture scale: every
    slide draws its own signal strength and share of signal patches,
    ``blank_frac`` of the slides carry no signal at all, class directions are
    group-confusable (:func:`class_direction_matrix`), and Metastatic slides
    get a weak global site shift so that the auxiliary head has something to
    learn. Deterministic in ``seed``; slides are written in manifest order."""
    if fmt != "npy":
        raise ValueError(f"write_graded_bags supports fmt='npy' only, got {fmt!r}")
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    label_map = task.label_dicts[0]
    site_map = task.label_dicts[1] if len(task.label_dicts) > 1 else {}
    n_classes = len(set(label_map.values()))
    dirs = class_direction_matrix(n_classes, dim, seed=seed + 7)
    site_dir = class_direction_matrix(2, dim, seed=seed + 31)[1]
    for row in manifest:
        n = rng.randint(n_patches_range[0], n_patches_range[1] + 1)
        feats = rng.randn(n, dim).astype(np.float32)
        if rng.rand() >= blank_frac:
            strength = rng.uniform(*strength_range)
            n_signal = max(1, int(n * rng.uniform(*signal_frac_range)))
            idx = rng.choice(n, size=n_signal, replace=False)
            feats[idx] += (strength * dirs[label_map[row["label"]]]).astype(np.float32)
        if site_map.get(row.get("site"), 0) == 1:
            feats += (site_strength * site_dir).astype(np.float32)
        np.save(data_dir / f"{row['slide_id']}.npy", feats)


def write_io_fixture(data_dir: str | os.PathLike, n_slides: int, bag_n: int = 8192, dim: int = 1024
                     ) -> tuple[Path, Path]:
    """The disk-fed probes' fixture (counterpart of ``bench._ensure_io_fixture``):
    ``n_slides`` ``.pt`` bags of ``bag_n x dim`` float32 under ``data_dir``,
    slide ``i`` the draws of ``np.random.RandomState(1000 + i).randn``, and a
    manifest ``io_{n_slides}.csv`` over them (one case a slide, 18 origins in
    turn, sex and site alternating). Files already there are reused, so that a
    probe run after another reads the same bags without writing them again.
    Returns (data_dir, csv_path)."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    csv_path = data_dir / f"io_{n_slides}.csv"
    if not csv_path.exists():
        rows = [{"slide_id": f"BENCH-SLIDE_{i}", "case_id": f"BENCH-PATIENT_{i}",
                 "label": DEFAULT_ORIGINS[i % len(DEFAULT_ORIGINS)], "sex": "F" if i % 2 else "M",
                 "site": "Primary" if i % 2 else "Metastatic"} for i in range(n_slides)]
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=MANIFEST_COLUMNS, lineterminator="\n")
            w.writeheader()
            w.writerows(rows)
    import torch

    # a slide's content is keyed by its index: a partly written directory
    # does not shift later slides onto earlier draws
    for i in range(n_slides):
        path = data_dir / f"BENCH-SLIDE_{i}.pt"
        if not path.exists():  # written under another name, then renamed: a cut write leaves no bag behind
            part = path.with_name(path.name + ".part")
            torch.save(torch.from_numpy(np.random.RandomState(1000 + i).randn(bag_n, dim).astype(np.float32)), part)
            os.replace(part, path)
    return data_dir, csv_path


def write_dummy_bags(
    data_dir: str | os.PathLike,
    manifest: list[dict[str, str]],
    task: TaskConfig,
    n_patches_range: tuple[int, int] = (64, 512),
    dim: int = 1024,
    fmt: str = "npy",
    seed: int = 0,
) -> None:
    """Write one bag file per slide in ``manifest`` under ``data_dir``."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    label_map = task.label_dicts[0]
    for row in manifest:
        n = rng.randint(n_patches_range[0], n_patches_range[1] + 1)
        feats = synth_bag(label_map[row["label"]], n, dim, rng)
        out = data_dir / f"{row['slide_id']}.{fmt}"
        if fmt == "npy":
            np.save(out, feats)
        elif fmt == "npz":
            coords = rng.randint(0, 100_000, size=(n, 2)).astype(np.int64)
            np.savez(out.with_suffix(""), features=feats, coords=coords)
        elif fmt == "h5":
            try:
                import h5py
            except ImportError as e:
                raise ImportError("writing .h5 bags needs h5py, which is not installed; use npy, npz or pt") from e
            with h5py.File(out, "w") as f:
                f.create_dataset("features", data=feats)
                f.create_dataset("coords", data=rng.randint(0, 100_000, size=(n, 2)).astype(np.int64))
        elif fmt == "pt":
            import torch

            torch.save(torch.from_numpy(feats), out)
        else:
            raise ValueError(f"unknown bag format {fmt!r}")
