"""``python -m toad_tpu_torch predict``: bulk inference over unlabeled slides.

Predicts tumour origin and site for a directory of feature bags (or the
slides of a manifest with ``slide_id`` and optionally ``sex``) and writes a
predictions CSV, the bytes ``python -m toad_tpu predict`` writes. Each slide
is one forward with its attention: on the card the pooling kernel in scored
mode (K1 in f32, in bf16 with ``--bf16``; K2 with ``--int8``), one launch per
slide and ensemble member. A last line on stderr gives the slides/s and the
pooling-kernel launches.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

# cells pandas' read_csv reads as missing (its default na_values)
_NA_CELLS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
                       "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def make_parser() -> argparse.ArgumentParser:
    from toad_tpu_torch.cli.common import add_buckets_arg, add_temperature_from_arg, add_xla_only_args

    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch predict", description=__doc__)
    p.add_argument("--ckpt", type=str, required=True, help="reference-layout s_k_checkpoint.pt")
    p.add_argument("--data_dir", type=str, required=True, help="directory of feature bags")
    p.add_argument("--csv", type=str, default=None,
                   help="manifest with slide_id[,sex]; defaults to every bag file in --data_dir")
    p.add_argument("--out", type=str, required=True, help="output predictions CSV")
    p.add_argument("--task", type=str, default=None, help="task name/JSON for class label names")
    p.add_argument("--n_classes", type=int, default=18)
    p.add_argument("--encoding_size", type=int, default=1024)
    p.add_argument("--sex", type=str, default=None, help="fallback sex (F/M) when the manifest has none")
    p.add_argument("--topk", type=int, default=3)
    p.add_argument("--bf16", action="store_true", default=False)
    p.add_argument("--int8", action="store_true", default=False,
                   help="quantized pooling (int8 kernel GEMMs; heads stay f32)")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="calibrated softmax temperature for class probabilities (fit with eval --calibrate)")
    p.add_argument("--ensemble", action="store_true", default=False,
                   help="mean-of-folds CV ensemble: --ckpt is a training results dir "
                        "(every s_<k>_checkpoint in it joins) or a comma-separated "
                        "checkpoint list; probabilities are the mean of the members' softmax")
    add_temperature_from_arg(p)
    add_buckets_arg(p)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default), cuda:<i> or cpu")
    add_xla_only_args(p, "pallas")
    return p


def read_manifest(path: str, fallback_sex: str | None) -> tuple[list[str], list]:
    """(slide ids, sexes) of a manifest, as the JAX CLI reads it with pandas:
    an all-integer id column loses its leading zeros, and a missing ``sex``
    cell (or column) falls back to ``--sex``."""
    from toad_tpu_torch.data.wsi_dataset import id_strings, read_csv_columns

    cols = read_csv_columns(path)
    if "slide_id" not in cols:
        raise ValueError(f"{path}: manifest needs a slide_id column")
    slides = [str(s) for s in id_strings(cols["slide_id"])]
    if "sex" in cols:
        sexes = [fallback_sex if v in _NA_CELLS else v for v in cols["sex"]]
    else:
        sexes = [fallback_sex] * len(slides)
    return slides, sexes


def main(argv=None) -> None:
    import torch

    from toad_tpu_torch.cli.common import build_inference, label_names, note_xla_only, parse_sex, resolve_device_arg
    from toad_tpu_torch.data.bags import bag_path
    from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
    from toad_tpu_torch.pipeline.infer import infer_feature_bag
    from toad_tpu_torch.utils.io import write_rows_csv

    args = make_parser().parse_args(argv)
    note_xla_only(args)
    topk = max(1, args.topk)
    data_dir = Path(args.data_dir)

    if args.csv:
        slides, sexes = read_manifest(args.csv, args.sex)
    else:
        files = sorted(
            p
            for ext in (".pt", ".h5", ".npy", ".npz")
            for p in data_dir.glob(f"*{ext}")
            if not p.name.endswith(".coords.npy")  # featurizer coords sidecars
        )
        if not files:
            raise FileNotFoundError(f"no bag files in {data_dir}")
        slides = sorted({p.stem for p in files})
        sexes = [args.sex] * len(slides)

    device = resolve_device_arg(args.device)
    inference = build_inference(args, device, compute_dtype="bfloat16" if args.bf16 else "float32")
    if args.ensemble:
        print(f"ensemble: {len(inference.members)} fold checkpoints")
    inv = label_names(args.task)

    rows = []
    launches0 = (cuda_pool.LAUNCHES, cuda_pool.SCORED_LAUNCHES, cuda_pool_int8.LAUNCHES, cuda_pool_int8.SCORED_LAUNCHES)
    t0 = time.perf_counter()
    for slide_id, sex in zip(slides, sexes):
        if sex is None:
            raise SystemExit(f"{slide_id}: no sex in manifest and no --sex fallback given")
        pred, _ = infer_feature_bag(inference, bag_path(data_dir, slide_id), parse_sex(sex))
        row = {
            "slide_id": slide_id,
            "sex": parse_sex(sex),
            "Y_hat": pred.y_hat,
            "prediction": inv.get(pred.y_hat, str(pred.y_hat)) if inv else str(pred.y_hat),
            "site_hat": pred.site_hat,
            "site": "Metastatic" if pred.site_hat else "Primary",
            "n_patches": int(pred.attention.shape[0]),
        }
        for r, (ci, prob) in enumerate(pred.topk[:topk], start=1):
            row[f"top{r}"] = inv.get(ci, str(ci)) if inv else str(ci)
            row[f"top{r}_p"] = round(float(prob), 6)
        for ci, prob in enumerate(pred.y_prob):
            row[f"p_{ci}"] = float(prob)
        row["site_p"] = float(pred.site_prob[1])
        rows.append(row)
        print(f"{slide_id}: {row['prediction']} (p={row['top1_p']}) {row['site']}")
    seconds = time.perf_counter() - t0
    k1, k1s, k2, k2s = (now - then for now, then in zip(
        (cuda_pool.LAUNCHES, cuda_pool.SCORED_LAUNCHES, cuda_pool_int8.LAUNCHES, cuda_pool_int8.SCORED_LAUNCHES), launches0))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_rows_csv(out, rows, index=False)
    print(f"wrote {out} ({len(rows)} slides)")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"predict: {len(rows)} slides in {seconds:.3f} s, {len(rows) / seconds if seconds else 0.0:.2f} slides/s on "
          f"{where}; pooling kernel launches {k1 + k2} (float kernel {k1}, {k1s} in scored mode; int8 kernel {k2}, "
          f"{k2s} in scored mode)", file=sys.stderr)


if __name__ == "__main__":
    main()
