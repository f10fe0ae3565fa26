"""``python -m toad_tpu_torch eval``: checkpoint evaluation over folds.

Counterpart of :mod:`toad_tpu.cli.evaluate`, with the flags of the reference
``eval_mtl_concat.py:19-39``; writes ``eval_results/EVAL_{save_exp_code}/
fold_{k}.csv`` + ``summary.csv`` with the reference's schema
(``eval_mtl_concat.py:108-149``), and beside them the confusion matrix and,
on request, bootstrap intervals, a fitted temperature and the mean-of-folds
ensemble.

Evaluation runs on the card unless ``--device cpu`` is given: the float
passes go through the hand-written pooling kernel, ``--int8`` through the
int8 one, with the bags quantized in the loader thread and sent as int8.
``--fold_devices N`` evaluates N folds at once, one a device (the visible
cards; on the CPU the CPU device repeated), each fold's outputs those of the
sequential run.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from toad_tpu_torch.cli.common import (
    add_buckets_arg,
    add_task_arg,
    add_xla_only_args,
    build_dataset,
    echo_settings,
    fold_devices_from_args,
    note_xla_only,
    require_data_root,
    resolve_buckets,
    resolve_device_arg,
)
from toad_tpu_torch.config import ModelConfig, fold_range
from toad_tpu_torch.utils.io import write_columns_csv, write_rows_csv



def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch eval", description="TOAD evaluation")
    add_task_arg(p)
    p.add_argument("--data_root_dir", type=str, default=None)
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--save_exp_code", type=str, default=None)
    p.add_argument("--models_exp_code", type=str, default=None)
    p.add_argument("--splits_dir", type=str, default=None)
    p.add_argument("--drop_out", action="store_true", default=False)
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--k_start", type=int, default=-1)
    p.add_argument("--k_end", type=int, default=-1)
    p.add_argument("--fold", type=int, default=-1)
    p.add_argument("--micro_average", action="store_true", default=False)
    p.add_argument("--split", type=str, choices=["train", "val", "test", "all"], default="test")
    p.add_argument("--encoding_size", type=int, default=1024, help="patch feature dimension")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_bag_size", type=int, default=None)
    add_buckets_arg(p, auto=True)
    p.add_argument("--bf16", action="store_true", default=False)
    add_xla_only_args(p, "pallas")
    p.add_argument("--int8", action="store_true", default=False,
                   help="quantized pooling (int8 GEMMs; heads and metrics stay f32; bags are quantized "
                   "in the loader thread and cross to the device as int8: a quarter of the bytes)")
    p.add_argument("--transfer_dtype", type=str, default="auto",
                   choices=["auto", "float32", "bfloat16", "int8"],
                   help="host-to-device feature wire. 'auto': int8 with --int8, bf16 with --bf16, else f32. "
                   "'float32' sends the stored rows as they are (with --int8 they are quantized on the device)")
    p.add_argument("--patient_bags", action="store_true", default=False, help="concat each patient's slides into one bag")
    p.add_argument("--bootstrap", type=int, default=0, metavar="N",
                   help="N slide-resampling bootstrap draws -> 95%% CIs for the headline "
                        "metrics, written to fold_{k}_ci.json (the paper reports CIs; "
                        "the reference repo computes none)")
    p.add_argument("--calibrate", action="store_true", default=False,
                   help="fit temperature scaling on the fold's val split and report "
                        "ECE/NLL before/after on the evaluated split "
                        "(fold_{k}_calibration.json); argmax/top-k are unchanged")
    p.add_argument("--ensemble", action="store_true", default=False,
                   help="also score the mean-of-folds ensemble (per-slide average of the "
                        "folds' class/site probabilities): writes ensemble.csv and appends an "
                        "'ensemble' row to summary.csv. Requires --split all, so every fold "
                        "scores the same slides (per-fold test splits are disjoint)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default), cuda:<i> or cpu")
    p.add_argument("--fold_devices", type=int, default=1, metavar="N",
                   help="evaluate folds concurrently, one per local device (N devices; "
                        "-1 = all). Per-fold outputs are identical to the sequential run; "
                        "fold log blocks flush atomically in completion order")
    return p


def _val_union(folds, splits_dir: Path) -> set:
    """The union of the folds' val slide ids, for the ensemble's temperature."""
    from toad_tpu_torch.data.splits import load_split_csv

    val_union: set = set()
    for fold in folds:
        split_csv = splits_dir / f"splits_{fold}.csv"
        if not split_csv.exists():
            raise SystemExit(
                f"--ensemble --calibrate fits on the folds' val slides but "
                f"{split_csv} does not exist (pass --splits_dir)"
            )
        val_union.update(load_split_csv(split_csv)["val"])
    return val_union


def main(argv=None):
    import torch

    from toad_tpu_torch.data.wsi_dataset import PatientBagSplit
    from toad_tpu_torch.evaluate.calibration import calibration_report, ensemble_calibration_report
    from toad_tpu_torch.evaluate.engine import (
        bootstrap_result_cis,
        cls_auc_with_sentinel,
        evaluate_checkpoint,
        topk_ladder,
    )
    from toad_tpu_torch.evaluate.metrics import binary_auc, topk_accuracy
    from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
    from toad_tpu_torch.train.checkpoint import checkpoint_name
    from toad_tpu_torch.utils import invert_labels

    args = make_parser().parse_args(argv)
    note_xla_only(args)
    device = resolve_device_arg(args.device)
    fold_devs = fold_devices_from_args(args.fold_devices, device) if args.fold_devices != 1 else None
    if args.save_exp_code is None:
        # never write to EVAL_None: the models code is the natural identity
        if args.models_exp_code is None:
            raise SystemExit("one of --save_exp_code / --models_exp_code is required")
        args.save_exp_code = f"{args.models_exp_code}_eval"
    require_data_root(args)
    task, dataset = build_dataset(args, data_dir=args.data_root_dir)
    buckets = resolve_buckets(args.buckets, dataset, patient_bags=args.patient_bags)

    save_dir = Path("./eval_results") / f"EVAL_{args.save_exp_code}"
    models_dir = Path(args.results_dir) / str(args.models_exp_code)
    save_dir.mkdir(parents=True, exist_ok=True)
    splits_dir = Path(args.splits_dir) if args.splits_dir else models_dir
    if not models_dir.is_dir():
        raise FileNotFoundError(f"models dir not found: {models_dir}")

    echo_settings(
        save_dir / f"eval_experiment_{args.save_exp_code}.txt",
        {
            "task": args.task,
            "split": args.split,
            "save_dir": str(save_dir),
            "models_dir": str(models_dir),
            "drop_out": args.drop_out,
            "micro_avg": args.micro_average,
        },
    )

    n_cls = task.n_classes[0]
    model_cfg = ModelConfig(
        in_dim=args.encoding_size,
        n_classes=n_cls,
        dropout=args.drop_out,
        compute_dtype="bfloat16" if args.bf16 else "float32",
    )

    folds = list(fold_range(args.k, args.k_start, args.k_end)) if args.fold == -1 else [args.fold]
    if not folds:
        raise SystemExit(
            f"empty fold window: k={args.k} k_start={args.k_start} k_end={args.k_end}"
        )

    def wrap(split):
        return PatientBagSplit(split) if args.patient_bags else split

    val_union: set = set()
    if args.ensemble:
        if args.split != "all":
            raise SystemExit("--ensemble requires --split all (per-fold test splits are "
                             "disjoint, so their probabilities cannot be averaged per slide)")
        if len(folds) < 2:
            raise SystemExit("--ensemble needs at least two folds in the window")
        if args.calibrate:
            # known before any fold has run: whether the folds' val slides meet the slides to be scored
            val_union = _val_union(folds, splits_dir)
            scored = wrap(dataset.subset(range(dataset.n_slides))).slide_ids
            if not np.isin(scored, list(val_union)).any():
                raise SystemExit(
                    f"--ensemble --calibrate fits one temperature on the union of the folds' val slides, but none "
                    f"of the {len(scored)} bags that --split all scores is among the {len(val_union)} val ids of "
                    f"{splits_dir}/splits_*.csv"
                    + (" (--patient_bags scores cases, the split files list slides)" if args.patient_bags else "")
                    + ": pass --splits_dir with the split files these models were trained on"
                )
    split_index = {"train": 0, "val": 1, "test": 2, "all": -1}[args.split]
    eval_kw = dict(batch_size=args.batch_size, max_bag_size=args.max_bag_size, int8=args.int8,
                   bucket_sizes=buckets, transfer_dtype=args.transfer_dtype)
    names = [invert_labels(task.label_dicts[0]).get(c, str(c)) for c in range(n_cls)]

    def _print(msg: str) -> None:
        print(msg, flush=True)

    def run_fold(fold, _payload=None, dev=None, log=_print):
        """Everything one fold needs: the eval pass and the per-fold
        artefacts. Only per-fold state, so that --fold_devices can run it one
        fold a device (``dev``, its lines through ``log``); ``dev=None`` is
        the sequential path on ``--device``. The launch counts it reports are
        the process's: under --fold_devices they take in the folds that ran
        beside it."""
        dev = device if dev is None else dev
        if split_index < 0:
            split = dataset.subset(range(dataset.n_slides))
        else:
            splits = dataset.return_splits_from_csv(splits_dir / f"splits_{fold}.csv")
            split = splits[split_index]
            if split is None:
                raise ValueError(f"fold {fold}: requested split {args.split!r} is empty")
        launches = (cuda_pool.LAUNCHES, cuda_pool_int8.LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        passes = []

        def evaluate(a_split, **kw):
            res = evaluate_checkpoint(models_dir / checkpoint_name(fold), wrap(a_split), model_cfg, **eval_kw,
                                      device=dev, **kw)
            passes.append(res.stats)
            return res

        res = evaluate(split, micro_average=args.micro_average)
        for ci, auc in enumerate(res.cls_aucs):
            log(f"class {ci} auc: {auc}")
        log(f"fold {fold}: cls_auc {res.cls_auc:.4f} acc {res.cls_acc:.4f} site_auc {res.site_auc:.4f}")
        res.write_csv(save_dir / f"fold_{fold}.csv")

        # confusion matrix (true rows x predicted columns, canonical class
        # names); the reference only prints per-class TPR (core_utils:242-259)
        cm = np.zeros((n_cls, n_cls), dtype=np.int64)
        np.add.at(cm, (res.df["Y"].astype(int), res.df["Y_hat"].astype(int)), 1)
        write_columns_csv(save_dir / f"fold_{fold}_confusion.csv", {n: cm[:, j] for j, n in enumerate(names)}, index=names)

        if args.calibrate:
            if args.split == "val":
                val_res = res  # the evaluated split is the val split: no second pass
            else:
                split_csv = splits_dir / f"splits_{fold}.csv"
                if not split_csv.exists():
                    raise SystemExit(
                        f"--calibrate fits on fold {fold}'s val split but {split_csv} "
                        f"does not exist (pass --splits_dir, or evaluate --split val)"
                    )
                val_split = dataset.return_splits_from_csv(split_csv)[1]
                if val_split is None:
                    raise ValueError(f"fold {fold}: --calibrate needs a val split in {split_csv}")
                val_res = evaluate(val_split)  # T is fitted at the same granularity as the eval
            rep = calibration_report(val_res.probs(), val_res.df["Y"], res.probs(), res.df["Y"])
            if args.split == "val":
                rep["note"] = "evaluated split IS the calibration split (self-calibrated)"
            elif args.split == "all":
                rep["note"] = ("evaluated split CONTAINS the calibration (val) slides "
                               "(partially self-calibrated)")
            (save_dir / f"fold_{fold}_calibration.json").write_text(json.dumps(rep, indent=2))
            log(f"fold {fold}: temperature {rep['temperature']:.3f}, "
                f"ece {rep['ece_before']:.4f} -> {rep['ece_after']:.4f}, "
                f"nll {rep['nll_before']:.4f} -> {rep['nll_after']:.4f}")

        ci_cols = {}
        if args.bootstrap > 0:
            cis = bootstrap_result_cis(res, n_cls, n_boot=args.bootstrap, micro_average=args.micro_average)
            (save_dir / f"fold_{fold}_ci.json").write_text(json.dumps(cis, indent=2))
            for m, ci in cis.items():
                log(f"fold {fold}: {m} 95% CI [{ci['lo']:.4f}, {ci['hi']:.4f}] "
                    f"(mean {ci['mean']:.4f}, {ci['n_valid']}/{ci['n_boot']} valid draws)")
            ci_cols = {
                f"{m}_ci_lo": ci["lo"] for m, ci in cis.items()
            } | {f"{m}_ci_hi": ci["hi"] for m, ci in cis.items()}

        for what, st in zip(("eval", "val"), passes):
            log(f"[fold {fold}] {what} pass: {st['n']} bags in {st['seconds']:.2f} s, "
                f"{st['n'] / max(st['seconds'], 1e-9):.1f} slides/s (data wait "
                f"{st['data_wait_s'] / max(st['seconds'], 1e-9):.0%}), wire {st['transfer_dtype']}, "
                f"{st['wire_bytes']} bytes to the device, feed {st['feed']}")
        k1, k2 = cuda_pool.LAUNCHES - launches[0], cuda_pool_int8.LAUNCHES - launches[1]
        log(f"[fold {fold}] eval batches {sum(st['n_batches'] for st in passes)}, pooling kernel launches {k1 + k2} "
            f"(float kernel {k1}, int8 kernel {k2})"
            + (f", peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB on "
               f"{torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else ""))
        row = {
            "folds": fold,
            "cls_test_auc": res.cls_auc,
            "cls_test_acc": res.cls_acc,
            "cls_top3_acc": res.topk.get(3, float("nan")),
            "cls_top5_acc": res.topk.get(5, float("nan")),
            "site_test_auc": res.site_auc,
            "site_test_acc": res.site_acc,
            **ci_cols,
        }
        return row, res

    if fold_devs is not None:
        # one fold per device (the work-queue engine of train --fold_devices); each fold's outputs are the
        # sequential run's
        from toad_tpu_torch.train.parallel_folds import map_folds_over_devices

        by_fold = map_folds_over_devices([(fold, None) for fold in folds], run_fold, n_devices=len(fold_devs),
                                         log_fn=_print, devices=fold_devs)
    else:
        by_fold = {fold: run_fold(fold) for fold in folds}
    rows = [by_fold[fold][0] for fold in folds]
    fold_results = [by_fold[fold][1] for fold in folds]

    if args.ensemble:
        base = fold_results[0].df
        for r in fold_results[1:]:
            if list(r.df["slide_id"]) != list(base["slide_id"]):
                raise RuntimeError("fold outputs score different slides; cannot ensemble")
        member = [r.probs() for r in fold_results]
        probs = np.mean(member, axis=0)
        site_p = np.mean([r.df["site_p"] for r in fold_results], axis=0)
        labels = base["Y"].astype(int)
        sites = base["site"].astype(int)
        y_hat = probs.argmax(axis=1)
        site_hat = (site_p >= 0.5).astype(int)

        # the per-fold engine's metric semantics (sentinels, top-k ladder,
        # macro = nanmean of OVR, or --micro_average)
        cls_auc, _ = cls_auc_with_sentinel(labels, probs, n_cls, args.micro_average)
        site_auc = -1.0 if len(np.unique(sites)) <= 1 else binary_auc(sites, site_p)
        topk = topk_accuracy(probs, labels, topk_ladder(n_cls))

        edf = {"slide_id": base["slide_id"], "sex": base["sex"], "Y": base["Y"], "Y_hat": y_hat,
               "site": base["site"], "site_hat": site_hat}
        for c in range(n_cls):
            edf[f"p_{c}"] = probs[:, c]
        edf["site_p"] = site_p
        write_columns_csv(save_dir / "ensemble.csv", edf)

        if args.calibrate:
            # one temperature for the whole ensemble, fitted with the transform
            # a deployed ensemble applies (per-member softmax at T, then the
            # mean) on the union of the folds' val slides; per-fold
            # temperatures do not transfer to the mixture
            rep = ensemble_calibration_report(np.stack(member), labels, np.isin(base["slide_id"], list(val_union)))
            rep["note"] = (
                "fit on the union of the folds' val slides (each was TRAINING data "
                "for the other folds: partially self-calibrated); eval-set ece/nll "
                "include the fit slides. Deploy with serve/infer --ensemble "
                "--temperature_from <this file>"
            )
            (save_dir / "ensemble_calibration.json").write_text(json.dumps(rep, indent=2))
            print(
                f"ensemble: temperature {rep['temperature']:.3f}, "
                f"ece {rep['ece_before']:.4f} -> {rep['ece_after']:.4f}, "
                f"nll {rep['nll_before']:.4f} -> {rep['nll_after']:.4f} "
                f"(fit on {rep['n_fit_slides']} val-union slides)"
            )
        rows.append(
            {
                "folds": "ensemble",
                "cls_test_auc": float(cls_auc),
                "cls_test_acc": float((y_hat == labels).mean()),
                "cls_top3_acc": topk.get(3, float("nan")),
                "cls_top5_acc": topk.get(5, float("nan")),
                "site_test_auc": float(site_auc),
                "site_test_acc": float((site_hat == sites).mean()),
            }
        )
        print(f"ensemble ({len(fold_results)} folds): cls_auc {cls_auc:.4f} "
              f"acc {rows[-1]['cls_test_acc']:.4f} site_auc {site_auc:.4f}")

    name = "summary.csv" if len(folds) == args.k else f"summary_partial_{folds[0]}_{folds[-1]}.csv"
    write_rows_csv(save_dir / name, rows)
    print(f"wrote {save_dir / name}")
    return rows


if __name__ == "__main__":
    main()
