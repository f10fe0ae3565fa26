"""``python -m toad_tpu_torch train``: k-fold training entry point.

Counterpart of :mod:`toad_tpu.cli.train`: the flags of the reference
``main_mtl_concat.py`` plus --batch_size, --bf16, --buckets, --resume,
--native_io, --device and the ops tooling (--profile, --debug_checks,
--debug_nans, --rss_restart_gb). Produces the reference's results layout:
``results/{exp_code}_s{seed}/`` with ``experiment_{exp_code}.txt``, per-fold
``splits_{i}.csv``, ``s_{i}_checkpoint.pt`` (reference layout, what ``serve
--ckpt`` reads), ``split_{i}_results.pkl``, and ``summary.csv``.

Training runs on the card unless ``--device cpu`` is given; validation and
the final passes go through the hand-written pooling kernel there.
``--data_shards`` / ``--bag_shards`` train over a ``('data', 'bag')`` mesh
of the visible cards (on the CPU, of the CPU device repeated), where the
eval passes pool each bag shard with the kernel's partial mode;
``--fold_devices N`` trains N folds at once, one a device. ``--pallas`` and
``--compile_cache``, which configure XLA, are taken with one note on stderr
(the kernel is the path on CUDA; nothing is compiled ahead of a run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from toad_tpu_torch.cli.common import (
    add_task_arg,
    add_xla_only_args,
    build_dataset,
    echo_settings,
    fold_devices_from_args,
    mesh_from_args,
    note_xla_only,
    require_data_root,
    resolve_buckets,
)
from toad_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, TrainConfig, fold_range
from toad_tpu_torch.utils.io import save_pkl, write_rows_csv
from toad_tpu_torch.utils.logging import make_writer
from toad_tpu_torch.utils.rng import seed_everything

SUMMARY_COLUMNS = (
    "folds", "cls_test_auc", "cls_val_auc", "cls_test_acc", "cls_val_acc",
    "site_test_auc", "site_val_auc", "site_test_acc", "site_val_acc",
)



def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Configurations for WSI training")
    add_task_arg(p)
    p.add_argument("--data_root_dir", type=str, default=None, help="directory containing feature bags")
    p.add_argument("--max_epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--reg", type=float, default=1e-5, help="weight decay")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--k_start", type=int, default=-1)
    p.add_argument("--k_end", type=int, default=-1)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--split_dir", type=str, default=None)
    p.add_argument("--log_data", action="store_true", default=False)
    p.add_argument("--testing", action="store_true", default=False, help="1%% subsample dry run")
    p.add_argument("--early_stopping", action="store_true", default=False)
    p.add_argument("--opt", type=str, choices=["adam", "sgd"], default="adam")
    p.add_argument("--drop_out", action="store_true", default=False)
    p.add_argument("--exp_code", type=str, required=True)
    p.add_argument("--weighted_sample", action="store_true", default=False)
    p.add_argument("--encoding_size", type=int, default=1024, help="patch feature dimension")
    p.add_argument("--batch_size", type=int, default=8, help="bags per step (1 = reference semantics)")
    p.add_argument("--max_bag_size", type=int, default=None)
    p.add_argument("--buckets", type=str, default=None, metavar="LIST|auto",
                   help="bucket ladder: comma-separated sizes, or 'auto' to derive quantile rungs from the "
                        "dataset's real patch counts (metadata reads only; cuts the padding of the default ladder)")
    p.add_argument("--bf16", action="store_true", default=False, help="bfloat16 compute (parameters stay float32)")
    p.add_argument("--resume", action="store_true", default=False,
                   help="preemption-tolerant per-epoch state snapshots + resume")
    p.add_argument("--rss_restart_gb", type=float, default=None, metavar="GB",
                   help="memory watermark (requires --resume): when host RSS crosses GB at an epoch boundary, "
                        "snapshot and re-exec this process, resuming where it left off (memory a runtime library "
                        "leaks outside Python's heap is only returned by a fresh process)")
    p.add_argument("--patient_bags", action="store_true", default=False, help="concat each patient's slides into one bag")
    p.add_argument("--bf16_transfer", action="store_true", default=False,
                   help="force bfloat16 feature transfer even under f32 compute (half the host-to-device bytes; "
                        "on automatically with --bf16)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default), cuda:<i> or cpu")
    p.add_argument("--native_io", type=str, choices=["auto", "on", "off"], default="auto",
                   help="bag feed: the native C++ loader (built with g++ at first use) where every bag is eligible "
                        "(auto), always (on: an ineligible bag raises), or numpy and torch (off)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the first train steps to DIR (open it in Perfetto or "
                        "chrome://tracing)")
    p.add_argument("--debug_checks", action="store_true", default=False,
                   help="checked train step: raise on NaN/Inf/bad labels (slow)")
    p.add_argument("--debug_nans", action="store_true", default=False,
                   help="global NaN trapping: autograd anomaly mode and a NaN check on every module's output (very slow)")
    add_xla_only_args(p, "pallas", "compile_cache")
    p.add_argument("--data_shards", type=int, default=1,
                   help="mesh data axis: bags of a batch split over this many devices (the visible cards; on the "
                        "CPU the CPU device repeated)")
    p.add_argument("--bag_shards", type=int, default=1,
                   help="mesh bag axis: each bag's patches split over this many devices; bucket rungs must be "
                        "multiples of 128 x bag_shards")
    p.add_argument("--fold_devices", type=int, default=1, metavar="N",
                   help="train folds concurrently, one per local device (N devices; -1 = all). "
                        "Bit-identical per fold to the sequential run; incompatible with "
                        "--data_shards/--bag_shards/--profile")
    return p


def config_from_args(args, n_classes: int, bucket_sizes: tuple[int, ...] | None = None) -> TrainConfig:
    return TrainConfig(
        exp_code=args.exp_code,
        task=args.task,
        results_dir=args.results_dir,
        split_dir=args.split_dir,
        max_epochs=args.max_epochs,
        seed=args.seed,
        k=args.k,
        k_start=args.k_start,
        k_end=args.k_end,
        early_stopping=args.early_stopping,
        resume=args.resume,
        rss_restart_gb=args.rss_restart_gb,
        profile_dir=args.profile,
        debug_checks=args.debug_checks,
        log_data=args.log_data,
        testing=args.testing,
        model=ModelConfig(
            in_dim=args.encoding_size,
            n_classes=n_classes,
            dropout=args.drop_out,
            compute_dtype="bfloat16" if args.bf16 else "float32",
        ),
        optim=OptimConfig(name=args.opt, lr=args.lr, weight_decay=args.reg),
        data=DataConfig(
            data_dir=args.data_root_dir,
            batch_size=args.batch_size,
            **({"bucket_sizes": bucket_sizes} if bucket_sizes else {}),
            max_bag_size=args.max_bag_size,
            weighted_sample=args.weighted_sample,
            testing_frac=0.01 if args.testing else None,
            native=args.native_io,
            patient_bags=args.patient_bags,
            # default 'auto': bf16 transfer iff --bf16 compute (numerically
            # invisible there, half the bytes); the flag forces it on
            transfer_dtype="bfloat16" if args.bf16_transfer else "auto",
        ),
        data_shards=args.data_shards,
        bag_shards=args.bag_shards,
    )


def write_summary(path: Path, rows: list[dict]) -> None:
    """``summary.csv`` as pandas writes the JAX CLI's: an unnamed index
    column, then one column per metric (a missing value, an AUC over one
    class, as an empty cell)."""
    write_rows_csv(path, rows, SUMMARY_COLUMNS)


def _reexec(argv: list[str]) -> None:
    """Replace this process with a fresh ``python -m toad_tpu_torch train
    <argv>``. Factored out so tests can intercept it."""
    os.execv(sys.executable, [sys.executable, "-m", "toad_tpu_torch", "train", *argv])


def main(argv=None):
    from toad_tpu_torch.train.loop import FoldTrainer, HostRssWatermark, resolve_device

    args = make_parser().parse_args(argv)
    note_xla_only(args)
    if args.rss_restart_gb is not None and not args.resume:
        raise SystemExit("--rss_restart_gb requires --resume (restart would lose all progress)")
    if args.fold_devices != 1:
        # fail before any dataset work: fold-parallel owns the devices whole,
        # one fold per device (train/parallel_folds.py)
        if args.data_shards > 1 or args.bag_shards > 1:
            raise ValueError("--fold_devices cannot combine with --data_shards/--bag_shards")
        if args.profile:
            raise ValueError("--profile supports one trace at a time; drop --fold_devices")
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"error: --device {args.device}: {e}") from None
    mesh = mesh_from_args(args.data_shards, args.bag_shards, device) if args.data_shards * args.bag_shards > 1 else None
    fold_devs = fold_devices_from_args(args.fold_devices, device) if args.fold_devices != 1 else None
    if args.debug_nans:
        from toad_tpu_torch.utils.debug import enable_debug_nans

        enable_debug_nans()
    seed_everything(args.seed)
    require_data_root(args)
    task, dataset = build_dataset(args, data_dir=args.data_root_dir)
    buckets = resolve_buckets(args.buckets, dataset, bag_shards=args.bag_shards, patient_bags=args.patient_bags)
    cfg = config_from_args(args, n_classes=task.n_classes[0], bucket_sizes=buckets)

    results_dir = Path(args.results_dir) / f"{args.exp_code}_s{args.seed}"
    results_dir.mkdir(parents=True, exist_ok=True)

    split_dir = Path(args.split_dir) if args.split_dir else Path("splits") / f"{task.name}_100"
    if not split_dir.is_dir():
        raise FileNotFoundError(f"split dir not found: {split_dir} (run python -m toad_tpu_torch create-splits first)")

    settings = cfg.settings_dict()
    settings["split_dir"] = str(split_dir)
    settings["device"] = str(device) if mesh is None else str(mesh)
    echo_settings(results_dir / f"experiment_{args.exp_code}.txt", settings)

    folds = fold_range(args.k, args.k_start, args.k_end)

    def load_fold_splits(i: int):
        splits = dataset.return_splits_from_csv(split_dir / f"splits_{i}.csv")
        if any(s is None for s in splits):
            raise ValueError(f"fold {i}: empty split in {split_dir / f'splits_{i}.csv'}")
        return splits

    def finish_fold(i: int, r: dict) -> dict:
        save_pkl(results_dir / f"split_{i}_results.pkl", r["results"])
        row = {"folds": i, **{c: r[c] for c in SUMMARY_COLUMNS[1:]}}
        if args.resume:
            (results_dir / f"fold_{i}_summary.json").write_text(json.dumps(row))
        return row

    rows_by_fold: dict[int, dict] = {}
    pending: list[int] = []
    for i in folds:
        fold_summary = results_dir / f"fold_{i}_summary.json"
        if args.resume and fold_summary.exists():
            # the fold finished in an earlier (preempted) run: do not retrain it
            rows_by_fold[i] = json.loads(fold_summary.read_text())
            print(f"fold {i}: already complete ({fold_summary}), skipping")
        else:
            pending.append(i)

    def log(msg: str) -> None:
        print(msg, flush=True)

    try:
        if fold_devs is not None and pending:
            # one fold per device, concurrently (train/parallel_folds.py); each fold's
            # artefacts are saved the moment it finishes, so that a preemption loses only
            # the folds in flight and --resume skips the finished ones
            from toad_tpu_torch.train.parallel_folds import train_folds_parallel

            train_folds_parallel(
                cfg,
                [(i, load_fold_splits(i)) for i in pending],
                results_dir,
                n_devices=len(fold_devs),
                log_fn=log,
                make_fold_writer=lambda i: make_writer(str(results_dir / str(i)), enabled=args.log_data),
                on_result=lambda i, r: rows_by_fold.__setitem__(i, finish_fold(i, r)),
                devices=fold_devs,
            )
        else:
            for i in pending:
                seed_everything(args.seed)
                splits = load_fold_splits(i)
                writer = make_writer(str(results_dir / str(i)), enabled=args.log_data)
                trainer = FoldTrainer(cfg, fold=i, results_dir=results_dir, writer=writer, mesh=mesh,
                                      device=device if mesh is None else None)
                r = trainer.train(*splits, log_fn=log)
                writer.close()
                rows_by_fold[i] = finish_fold(i, r)
    except (HostRssWatermark, RuntimeError) as e:
        # fold-parallel wraps a worker's error in a RuntimeError (its cause)
        wm = e if isinstance(e, HostRssWatermark) else e.__cause__
        if not isinstance(wm, HostRssWatermark):
            raise
        # memory outside Python's heap is not reclaimable in process: replace
        # the process; completed folds skip via fold_<i>_summary.json, the
        # interrupted fold resumes from the snapshot the watermark just saved
        print(f"{wm} — re-exec to reclaim the process's memory", flush=True)
        _reexec(list(argv) if argv is not None else sys.argv[1:])
        return  # unreachable after execv; present for monkeypatched tests

    rows = [rows_by_fold[i] for i in folds]
    name = "summary.csv" if len(folds) == args.k else f"summary_partial_{folds.start}_{folds.stop}.csv"
    write_summary(results_dir / name, rows)
    print(f"finished! wrote {results_dir / name}")
    return rows


if __name__ == "__main__":
    main()
