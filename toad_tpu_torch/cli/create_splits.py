"""``python -m toad_tpu_torch create-splits``: stratified k-fold split files.

Counterpart of :mod:`toad_tpu.cli.create_splits`, with the flags of the
reference ``create_splits.py`` (label_frac, seed, k, hold_out_test,
split_code, task) plus explicit --val_frac/--test_frac. Writes the three
reference formats per fold: ``splits_{i}.csv``, ``splits_{i}_bool.csv``,
``splits_{i}_descriptor.csv``. The same seed draws the same folds as the
JAX package.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from toad_tpu_torch.cli.common import add_task_arg, build_dataset
from toad_tpu_torch.data.splits import (
    expand_patient_split,
    generate_splits,
    sample_held_out,
    save_split_boolean,
    save_split_columnar,
    split_descriptor,
    split_file,
)
from toad_tpu_torch.utils.rng import seed_everything


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Create stratified splits for whole-slide classification")
    add_task_arg(p)
    p.add_argument("--label_frac", type=float, default=-1, help="fraction of training labels to keep")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--k", type=int, default=10, help="number of splits")
    p.add_argument("--val_frac", type=float, default=0.1)
    p.add_argument("--test_frac", type=float, default=0.2)
    p.add_argument("--hold_out_test", action="store_true", default=False)
    p.add_argument("--split_code", type=str, default=None)
    p.add_argument("--split_root", type=str, default="splits")
    return p


def main(argv=None) -> str:
    args = make_parser().parse_args(argv)
    seed_everything(args.seed)
    task, ds = build_dataset(args)

    if task.patient_strat:
        cls_ids = ds.patient_cls_ids
        samples = len(ds.patient_ids)
    else:
        cls_ids = ds.slide_cls_ids
        samples = ds.n_slides
    counts = np.array([len(c) for c in cls_ids])
    val_num = np.floor(counts * args.val_frac).astype(int)
    test_num = np.floor(counts * args.test_frac).astype(int)
    print("val per class:", val_num)
    print("test per class:", test_num)

    label_frac = args.label_frac if args.label_frac > 0 else 1.0
    custom_test = sample_held_out(cls_ids, test_num, seed=args.seed) if args.hold_out_test else None

    code = args.split_code or task.name
    split_dir = Path(args.split_root) / f"{code}_{int(label_frac * 100)}"
    split_dir.mkdir(parents=True, exist_ok=True)

    gen = generate_splits(
        cls_ids,
        val_num,
        test_num,
        samples,
        n_splits=args.k,
        seed=args.seed,
        label_frac=label_frac,
        custom_test_ids=custom_test,
    )
    for i, spec in enumerate(gen):
        if task.patient_strat:
            spec = expand_patient_split(spec, ds.patient_ids, ds.case_ids)
        spec.validate_disjoint()
        desc = split_descriptor(spec, ds.getlabel, task.label_dicts, ds.num_classes)
        desc.to_csv(split_file(split_dir, i, "descriptor"))
        ids = {
            "train": list(ds.slide_ids[spec.train]),
            "val": list(ds.slide_ids[spec.val]),
            "test": list(ds.slide_ids[spec.test]),
        }
        save_split_columnar(ids, split_file(split_dir, i))
        save_split_boolean(ids, split_file(split_dir, i, "bool"))
        print(f"fold {i}: train {len(spec.train)} / val {len(spec.val)} / test {len(spec.test)}")
    print(f"wrote {args.k} folds to {split_dir}")
    return str(split_dir)


if __name__ == "__main__":
    main()
