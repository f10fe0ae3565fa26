"""Device-parallel k-fold cross-validation: one fold per device.

PyTorch counterpart of :mod:`toad_tpu.train.parallel_folds`. The reference
trains its k CV folds strictly one after another. Folds are embarrassingly
parallel: each owns its weights, its split and its random streams, and
shares nothing. So the code places whole folds: fold i's model, optimizer
state and every batch live on one device, and one worker thread per device
drives the unchanged :class:`~toad_tpu_torch.train.loop.FoldTrainer` there.
A worker makes its device the current one before it builds the fold's
trainer. CUDA launches are asynchronous and PyTorch releases the GIL in its
kernels, so several cards stay busy from one Python process.

Nothing about the per-fold computation changes: the same seeded generators
per fold (the model's initial weights, the dropout masks), the same batch
order (the batcher's random state is private, seeded ``seed + fold*1009``)
and the same step. So each fold's results are bit-identical to a sequential
run on the same hardware (``tests/test_torch_port_parallel_folds.py`` holds
this on the CPU, whose device a list may repeat, as ``[cpu] * 2``).

Mutually exclusive with a mesh within a fold (``--data_shards`` /
``--bag_shards``): one fold per device already takes the devices whole.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Iterable, Sequence

import torch

from toad_tpu_torch.config import TrainConfig
from toad_tpu_torch.parallel.mesh import visible_devices
from toad_tpu_torch.train.loop import FoldTrainer


def resolve_fold_devices(n_requested: int, devices: Sequence[torch.device] | None = None) -> list[torch.device]:
    """The first ``n_requested`` of ``devices`` (all of them for ``-1``):
    the visible cards when None; an explicit list may repeat a device."""
    devs = [torch.device(d) for d in devices] if devices is not None else visible_devices()
    if n_requested == -1:
        return devs
    if n_requested < 1:
        raise ValueError(f"fold_devices must be >= 1 or -1 (all), got {n_requested}")
    if n_requested > len(devs):
        raise ValueError(
            f"fold_devices={n_requested} but only {len(devs)} local devices are visible"
        )
    return devs[:n_requested]


def _current(dev: torch.device):
    """``dev`` as the current CUDA device for the calling thread (nothing to
    do for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def map_folds_over_devices(
    jobs: Iterable[tuple[int, Any]],
    fn: Callable[[int, Any, Any, Callable[[str], None]], Any],
    n_devices: int = -1,
    log_fn: Callable[[str], None] = print,
    on_result: Callable[[int, Any], None] | None = None,
    what: str = "fold",
    stream_logs: bool = False,
    devices: Sequence[torch.device] | None = None,
) -> dict[int, Any]:
    """Run ``fn(fold, payload, device, log)`` for every ``(fold, payload)``
    job, fanned out over devices (:func:`resolve_fold_devices` of
    ``n_devices`` and ``devices``): the engine behind fold-parallel training
    and evaluation.

    One pinned worker thread per device drives a shared work queue (a device
    never runs two folds at once; a free device picks up the next fold with
    no round barrier), with its device current while ``fn`` runs. ``log``
    passed to ``fn`` buffers that fold's lines and flushes them at once
    through ``log_fn`` when the fold finishes, so that concurrent folds'
    output never interleaves (``stream_logs=True`` emits lines live under
    the lock instead: right for long training runs, whose per-epoch lines
    are the progress display). ``on_result(fold, result)`` fires under the
    same lock the moment each fold completes, even if a later fold errors,
    so that callers can persist per-fold artifacts as they come. The first
    error is re-raised (as ``RuntimeError`` naming the fold) after all
    workers drain.
    """
    devices = resolve_fold_devices(n_devices, devices)
    job_q: queue.Queue = queue.Queue()
    n_jobs = 0
    for job in jobs:
        job_q.put(job)
        n_jobs += 1
    results: dict[int, Any] = {}
    errors: list[tuple[int, BaseException]] = []
    lock = threading.Lock()

    def locked_log(msg: str) -> None:
        with lock:
            log_fn(msg)

    def worker(dev) -> None:
        while True:
            try:
                fold, payload = job_q.get_nowait()
            except queue.Empty:
                return
            lines: list[str] = []
            log = locked_log if stream_logs else lines.append
            try:
                with _current(dev):
                    r = fn(fold, payload, dev, log)
                with lock:
                    for line in lines:
                        log_fn(line)
                    results[fold] = r
                    if on_result is not None:
                        on_result(fold, r)
            except BaseException as e:  # noqa: BLE001 - re-raised after join
                with lock:
                    for line in lines:
                        log_fn(line)
                    errors.append((fold, e))
                return

    threads = [
        threading.Thread(target=worker, args=(d,), name=f"{what}-worker-{i}", daemon=True)
        for i, d in enumerate(devices[: max(1, min(len(devices), n_jobs))])
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    if errors:
        fold, err = errors[0]
        raise RuntimeError(f"{what} {fold} failed under fold-parallel execution") from err
    missing = n_jobs - len(results)
    if missing:
        # a worker died without recording an error (should be unreachable)
        raise RuntimeError(f"{missing} {what}s did not complete")
    return results


def train_folds_parallel(
    cfg: TrainConfig,
    jobs: Iterable[tuple[int, Sequence]],
    results_dir,
    n_devices: int = -1,
    log_fn: Callable[[str], None] = print,
    make_fold_writer: Callable[[int], Any] | None = None,
    on_result: Callable[[int, dict], None] | None = None,
    devices: Sequence[torch.device] | None = None,
) -> dict[int, dict]:
    """Train every ``(fold, (train, val, test))`` job, folds fanned out over
    devices (the visible cards, or ``devices``). Returns ``{fold:
    FoldTrainer.train() result}``.

    Scheduling is a work queue with one pinned worker thread per device:
    devices never run two folds at once, and when there are more folds than
    devices each worker picks up the next fold as soon as its current one
    finishes (no barrier between rounds, which would idle devices behind the
    slowest early-stopping fold).

    ``on_result(fold, result)`` fires (under a lock) the moment a fold
    finishes, even if another fold later errors out. The CLI uses it to
    persist per-fold artifacts as they come, so that a preemption mid-
    experiment loses only the folds in flight.
    """
    if cfg.data_shards * cfg.bag_shards > 1:
        raise ValueError(
            "fold-parallel training cannot combine with data_shards/bag_shards "
            "(one fold per chip already owns the mesh)"
        )
    if cfg.profile_dir:
        raise ValueError("--profile supports one trace at a time; run it with fold_devices=1")

    def train_one(fold: int, splits: Sequence, dev, log: Callable[[str], None]) -> dict:
        writer = make_fold_writer(fold) if make_fold_writer is not None else None
        trainer = FoldTrainer(cfg, fold=fold, results_dir=results_dir, writer=writer, device=dev)
        log(f"[fold {fold}] -> {dev}")
        r = trainer.train(*splits, log_fn=log)
        if writer is not None:
            writer.close()
        return r

    # stream_logs: per-epoch lines are the progress display on long runs
    return map_folds_over_devices(
        jobs, train_one, n_devices=n_devices, log_fn=log_fn,
        on_result=on_result, stream_logs=True, devices=devices,
    )
