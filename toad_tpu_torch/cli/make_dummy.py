"""``python -m toad_tpu_torch make-dummy``: generate a self-contained synthetic
fixture (manifest CSV + feature bags + task JSON) for smoke runs.

Counterpart of :mod:`toad_tpu.cli.make_dummy`; the same seed writes the same
manifest and bags as there.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from toad_tpu_torch.data.synthetic import dummy_task, write_dummy_bags, write_dummy_csv


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate synthetic TOAD fixture data")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--n_patients", type=int, default=400)
    p.add_argument("--max_slides_per_patient", type=int, default=3)
    p.add_argument("--min_patches", type=int, default=64)
    p.add_argument("--max_patches", type=int, default=512)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--fmt", type=str, default="npy", choices=["npy", "npz", "h5", "pt"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--task_name", type=str, default="dummy_mtl_concat")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    csv_path = out / "dataset_csv" / "dummy_dataset.csv"
    manifest = write_dummy_csv(
        csv_path,
        n_patients=args.n_patients,
        max_slides_per_patient=args.max_slides_per_patient,
        seed=args.seed,
    )
    task = dummy_task(str(csv_path), name=args.task_name)
    write_dummy_bags(
        out / "bags",
        manifest,
        task,
        n_patches_range=(args.min_patches, args.max_patches),
        dim=args.dim,
        fmt=args.fmt,
        seed=args.seed,
    )
    task_path = out / "tasks" / f"{args.task_name}.json"
    task_path.parent.mkdir(parents=True, exist_ok=True)
    task_path.write_text(task.to_json())
    print(f"wrote {len(manifest)} slides to {out} (csv, bags/, tasks/{args.task_name}.json)")
    return out


if __name__ == "__main__":
    main()
