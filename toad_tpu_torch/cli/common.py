"""Shared CLI plumbing: task loading, dataset construction, settings echo,
bucket ladders, the serving temperature (counterpart of
:mod:`toad_tpu.cli.common`)."""

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


def resolve_device_arg(value: str):
    """``--device`` as a torch.device: the card unless the CPU is asked for.
    Exits, naming ``--device cpu``, where CUDA is asked for and absent."""
    from toad_tpu_torch.train.loop import resolve_device

    try:
        return resolve_device(value)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"error: --device {value}: {e}") from None


def add_task_arg(p: argparse.ArgumentParser) -> None:
    from toad_tpu_torch.registry import list_tasks

    p.add_argument(
        "--task",
        type=str,
        required=True,
        help=f"task name from the registry or path to a task JSON (available: {list_tasks()})",
    )
    p.add_argument("--csv_path", type=str, default=None, help="override the task's csv path")


def require_data_root(args) -> None:
    """Fail fast when a bag-reading command starts without --data_root_dir:
    otherwise the omission only surfaces at the first bag access, inside a
    prefetch worker."""
    d = getattr(args, "data_root_dir", None)
    if d is None:
        raise SystemExit("error: --data_root_dir is required (directory containing feature bags)")
    if not Path(d).is_dir():
        raise SystemExit(f"error: --data_root_dir {d!r} is not a directory")


def build_dataset(args, data_dir=None, print_info: bool = True):
    """(task, WSIBagDataset) from --task / --csv_path."""
    from toad_tpu_torch.data.wsi_dataset import WSIBagDataset
    from toad_tpu_torch.registry import load_task

    task = load_task(args.task)
    ds = WSIBagDataset(
        task,
        csv_path=args.csv_path,
        data_dir=data_dir,
        seed=getattr(args, "seed", 7),
        print_info=print_info,
    )
    return task, ds


def echo_settings(path: str | os.PathLike, settings: dict) -> None:
    from toad_tpu_torch.utils.io import write_settings

    write_settings(path, settings)
    print("################# Settings ###################")
    for k, v in settings.items():
        print(f"{k}:  {v}")


# flags of the JAX CLIs that configure XLA: taken, each with one note on stderr
# when given, since on CUDA neither changes a result; the JAX user's command
# line runs unchanged
XLA_ONLY = {
    "pallas": "on CUDA the hand-written pooling kernels are always the path",
    "compile_cache": "it names XLA's persistent compilation cache, and nothing here is compiled ahead of a run "
                     "(the CUDA kernels build once, into toad_tpu_torch/_build/)",
}


def add_xla_only_args(p: argparse.ArgumentParser, *flags: str) -> None:
    """Add the JAX CLI's XLA-only ``flags`` (keys of ``XLA_ONLY``), off by default."""
    for flag in flags:
        why = f"accepted for the JAX CLI's command lines and ignored: {XLA_ONLY[flag]}"
        if flag == "pallas":
            p.add_argument("--pallas", action="store_true", default=False, help=why)
        else:
            p.add_argument(f"--{flag}", type=str, default=None, metavar="DIR", help=why)


def note_xla_only(args) -> None:
    """One note on stderr for each XLA-only flag that was given."""
    for flag, why in XLA_ONLY.items():
        if getattr(args, flag, None) not in (None, False):
            print(f"--{flag} has no effect here: {why}", file=sys.stderr)


def add_buckets_arg(p: argparse.ArgumentParser, auto: bool = False) -> None:
    extra = ", or 'auto' to derive quantile rungs from the dataset's real patch counts (metadata reads only)" if auto else ""
    p.add_argument(
        "--buckets", type=str, default=None, metavar="LIST" + ("|auto" if auto else ""),
        help="bucket ladder override: comma-separated bag lengths (positive integers; "
        f"the CUDA kernel masks ragged row tiles, so no multiple is required){extra}",
    )


def resolve_buckets(
    value: str | None, dataset=None, *, bag_shards: int = 1, patient_bags: bool = False
) -> tuple[int, ...] | None:
    """--buckets: None (keep the default ladder), an explicit comma list,
    sorted and validated, or 'auto': a quantile ladder over the whole
    dataset's real patch counts (rounded up to multiples of 128), so that
    every fold and split shares one set of shapes.

    Under a bag axis (``bag_shards`` > 1) every rung must be a multiple of
    128 x ``bag_shards``, the JAX CLI's rule: each shard's slice of a bag
    is then a whole number of 128-row tiles (the 'auto' ladder is rounded up
    to that multiple). Without one the CUDA kernel masks ragged row tiles,
    so any positive length is taken."""
    if not value:
        return None
    multiple = 128 * max(int(bag_shards), 1)
    if value.strip().lower() == "auto":
        if dataset is None:
            raise SystemExit("--buckets auto needs a dataset (use an explicit list here)")
        from toad_tpu_torch.data.batching import auto_bucket_ladder

        split = dataset.subset(range(dataset.n_slides))
        if patient_bags:
            from toad_tpu_torch.data.wsi_dataset import PatientBagSplit

            split = PatientBagSplit(split)
        ladder = auto_bucket_ladder(split, multiple_of=multiple)
        print(f"auto bucket ladder ({len(split)} bags): {list(ladder)}")
        return ladder
    try:
        ladder = tuple(int(x) for x in value.split(","))
    except ValueError:
        raise SystemExit(f"--buckets {value!r}: expected comma-separated integers") from None
    if bag_shards > 1:
        bad = [b for b in ladder if b <= 0 or b % multiple]
        if bad:
            raise SystemExit(f"--buckets {bad} must be positive multiples of {multiple} "
                             f"(Pallas tile 128 x bag_shards {bag_shards})")
    bad = [b for b in ladder if b <= 0]
    if bad:
        raise SystemExit(f"--buckets {bad} must be positive")
    return tuple(sorted(ladder))


def mesh_from_args(data_shards: int | None, bag_shards: int | None, device):
    """The ``(data, bag)`` mesh of the CLIs' ``--data_shards`` /
    ``--bag_shards``: over the visible cards on the card (a shape past them
    is refused with ``mesh_shape_for``'s text), and on the CPU over the CPU
    device repeated as many times as the flags ask (a flag not given counts
    1). Exits with the message where the shape does not resolve."""
    from toad_tpu_torch.parallel.mesh import make_mesh

    devices = [device] * ((data_shards or 1) * (bag_shards or 1)) if device.type == "cpu" else None
    try:
        return make_mesh(data_shards, bag_shards, devices=devices)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"error: --data_shards {data_shards} --bag_shards {bag_shards}: {e}") from None


def fold_devices_from_args(n: int, device) -> list:
    """The devices of ``--fold_devices N``: the visible cards on the card
    (-1 all of them; more than there are is refused with
    ``resolve_fold_devices``' text), the CPU device N times on the CPU (-1:
    once). Exits with the message where N does not resolve."""
    from toad_tpu_torch.train.parallel_folds import resolve_fold_devices

    try:
        return resolve_fold_devices(n, [device] * max(n, 1) if device.type == "cpu" else None)
    except ValueError as e:
        raise SystemExit(f"error: --fold_devices {n}: {e}") from None


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


def build_inference(args, device, compute_dtype: str = "float32"):
    """The ``SlideInference`` (or, with ``--ensemble``, the
    ``EnsembleInference``) of ``--ckpt`` that ``infer`` and ``predict`` run:
    ``--encoding_size``, ``--n_classes``, ``--int8``, the temperature and the
    bucket ladder from their flags."""
    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.pipeline.infer import EnsembleInference, SlideInference

    model_cfg = ModelConfig(in_dim=args.encoding_size, n_classes=args.n_classes, compute_dtype=compute_dtype)
    kw = dict(int8=args.int8, temperature=resolve_temperature(args.temperature, args.temperature_from),
              bucket_sizes=resolve_buckets(args.buckets), device=device)
    if args.ensemble:
        return EnsembleInference.from_spec(args.ckpt, model_cfg, **kw)
    return SlideInference.from_checkpoint(args.ckpt, model_cfg, **kw)


def label_names(task: str | None) -> dict[int, str] | None:
    """Index -> origin name of a task's first label dict, or None without a task."""
    if not task:
        return None
    from toad_tpu_torch.registry import load_task
    from toad_tpu_torch.utils import invert_labels

    return invert_labels(load_task(task).label_dicts[0])
