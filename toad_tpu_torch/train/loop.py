"""Per-fold training: update and eval steps, early stopping, checkpoints.

PyTorch counterpart of :mod:`toad_tpu.train.loop`, with the reference
trainer's orchestration (``utils/core_utils_mtl_concat.py:87-187``): loss =
0.75 CE(origin) + 0.25 CE(site), early stopping on the cls val loss with
patience 20 / earliest epoch 50, best-checkpoint restore, and the same final
summaries.

- The update step is the model's training forward under autograd plus one
  optimizer step. As in the JAX package, no pooling kernel has a backward:
  the large products of the step are plain ``torch.matmul`` / ``bmm``.
- Validation and the final val/test passes run the eval forward, which on
  CUDA is the hand-written pooling kernel (classification mode).
- The step's scalars and predictions are gathered into one device tensor
  and brought to the host in one copy per step (the JAX trainer pulls its
  metrics every step too); the share of an epoch that the host spent
  waiting for the input pipeline is logged beside slides/s.
- Under a ``('data', 'bag')`` mesh (``mesh=``, or ``data_shards`` x
  ``bag_shards`` > 1 in the config) the model lives on the mesh's first
  device, every batch is placed over the mesh by
  :func:`~toad_tpu_torch.parallel.sharding.shard_batch`, and the steps run
  :meth:`~toad_tpu_torch.models.toad_mil.ToadMIL.forward_sharded`; the loss,
  its metrics and their one copy to the host are on the first device, over
  the whole batch.
- Ops tooling, as in the JAX trainer: ``debug_checks`` swaps in the checked
  step (:mod:`toad_tpu_torch.utils.debug`), ``profile_dir`` traces the first
  ten steps (:class:`~toad_tpu_torch.utils.profiling.StepTracer`), and
  ``rss_restart_gb`` snapshots and raises :class:`HostRssWatermark` at the
  end of an epoch where the process's RSS has crossed it.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from toad_tpu_torch.config import TrainConfig
from toad_tpu_torch.data.batching import BagBatcher, resolve_transfer_dtype
from toad_tpu_torch.data.splits import save_split_columnar
from toad_tpu_torch.evaluate.metrics import AccuracyLogger
from toad_tpu_torch.evaluate.runner import batch_to_dict, make_eval_step, patient_results_from_pass, run_eval_pass
from toad_tpu_torch.models.interop import reference_state_dict
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops import cuda_pool
from toad_tpu_torch.parallel.sharding import ShardedBatch
from toad_tpu_torch.train.checkpoint import (
    checkpoint_name,
    load_params_any,
    recover_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from toad_tpu_torch.train.optim import make_optimizer
from toad_tpu_torch.utils import profiling
from toad_tpu_torch.utils.profiling import StepTracer
from toad_tpu_torch.utils.rng import seed_everything

# the scalars a train step reports, in the order of its packed metrics tensor
_STEP_SCALARS = ("loss", "cls_loss_sum", "site_loss_sum", "n_bags", "cls_correct", "site_correct")


class HostRssWatermark(RuntimeError):
    """Raised at an epoch boundary when host RSS crosses
    ``TrainConfig.rss_restart_gb``, AFTER a fresh resume snapshot was saved.

    The process is expected to re-exec itself and resume (``cli/train.py``
    does): memory that a runtime library leaks outside Python's heap cannot
    be reclaimed in process, but a fresh process starts without it."""

    def __init__(self, rss_gb: float, limit_gb: float, epoch: int):
        self.rss_gb, self.limit_gb, self.epoch = rss_gb, limit_gb, epoch
        super().__init__(
            f"host RSS {rss_gb:.1f} GiB >= rss_restart_gb {limit_gb:.1f} after epoch "
            f"{epoch}; resume snapshot saved — re-exec this process and resume"
        )


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises where CUDA is asked for (or defaulted to) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda, cuda:<i> or cpu, got {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for but CUDA is not available here; pass --device cpu (device='cpu') to run on the CPU")
    return device


def make_loss_fn(model: ToadMIL, cls_w: float, site_w: float):
    def loss_fn(batch: dict[str, torch.Tensor], generator: torch.Generator | None):
        if isinstance(batch, ShardedBatch):  # placed on a mesh: the heads and the loss run on its first device
            out = model.forward_sharded(batch, train=True, generator=generator, need_attention=False)
        else:
            out = model(
                batch["features"], batch["patch_mask"], batch["sex"],
                train=True, generator=generator, need_attention=False,
            )
        bag_mask = batch["bag_mask"]
        n = bag_mask.sum().clamp_min(1.0)
        # zero the labels of padding bags BEFORE the CE: an out-of-range label
        # there would poison it, and NaN * 0 is still NaN, so masking by
        # multiplication alone cannot contain it
        label = torch.where(bag_mask > 0, batch["label"], 0)
        site = torch.where(bag_mask > 0, batch["site"], 0)
        cls_ce = (F.cross_entropy(out.logits, label, reduction="none") * bag_mask).sum() / n
        site_ce = (F.cross_entropy(out.site_logits, site, reduction="none") * bag_mask).sum() / n
        loss = cls_w * cls_ce + site_w * site_ce
        aux = {"cls_loss": cls_ce, "site_loss": site_ce, "y_hat": out.y_hat, "site_hat": out.site_hat}
        return loss, aux

    return loss_fn


def make_train_step(model: ToadMIL, optimizer: torch.optim.Optimizer, cls_w: float, site_w: float):
    """``step(batch, generator) -> packed`` takes one optimizer step in place
    and returns one f32 device tensor: the scalars of ``_STEP_SCALARS``, then
    ``y_hat`` [B] and ``site_hat`` [B]. :func:`unpack_metrics` reads it on
    the host."""
    loss_fn = make_loss_fn(model, cls_w, site_w)

    def step(batch: dict[str, torch.Tensor], generator: torch.Generator | None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, generator)
        loss.backward()
        optimizer.step()
        return pack_step_metrics(loss, aux, batch)

    return step


@torch.no_grad()
def pack_step_metrics(loss: torch.Tensor, aux: dict[str, torch.Tensor], batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """A step's packed metrics tensor (the layout :func:`unpack_metrics` reads)."""
    bag_mask = batch["bag_mask"]
    n = bag_mask.sum()
    scalars = torch.stack([
        loss.detach(), aux["cls_loss"].detach() * n, aux["site_loss"].detach() * n, n,
        ((aux["y_hat"] == batch["label"]) * bag_mask).sum(),
        ((aux["site_hat"] == batch["site"]) * bag_mask).sum(),
    ]).float()
    return torch.cat([scalars, aux["y_hat"].float(), aux["site_hat"].float()])


def unpack_metrics(packed: torch.Tensor) -> dict[str, Any]:
    """One device-to-host copy of a step's packed metrics -> floats and the
    int prediction arrays."""
    host = packed.cpu().numpy()
    k = len(_STEP_SCALARS)
    b = (len(host) - k) // 2
    out: dict[str, Any] = {name: float(host[i]) for i, name in enumerate(_STEP_SCALARS)}
    out["y_hat"] = host[k:k + b].astype(np.int64)
    out["site_hat"] = host[k + b:].astype(np.int64)
    return out


class EarlyStopping:
    """Patience-based stopping on val loss (reference ``:44-85``): stops after
    ``patience`` non-improvements, but never before epoch ``stop_epoch``."""

    def __init__(self, patience: int = 20, stop_epoch: int = 50):
        self.patience = patience
        self.stop_epoch = stop_epoch
        self.counter = 0
        self.best: float | None = None
        self.early_stop = False

    def __call__(self, epoch: int, val_loss: float) -> bool:
        """Returns True when this epoch's state should be checkpointed."""
        # ties count as improvements, like the reference
        improved = self.best is None or val_loss <= self.best
        if improved:
            self.best = val_loss
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience and epoch > self.stop_epoch:
            self.early_stop = True
        return False

    def state_dict(self) -> dict[str, Any]:
        return {
            "counter": int(self.counter),
            "best": float("inf") if self.best is None else float(self.best),
            "early_stop": int(self.early_stop),
        }

    def load_state_dict(self, d: dict[str, Any]) -> None:
        self.counter = int(d["counter"])
        best = float(d["best"])
        self.best = None if np.isinf(best) else best
        self.early_stop = bool(d["early_stop"])


class FoldTrainer:
    """Owns one fold end to end (reference ``train``, ``core_utils:87-187``).
    ``device=None`` is the card; pass ``"cpu"`` to train on the CPU. ``mesh``
    (a :class:`~toad_tpu_torch.parallel.mesh.DeviceMesh`) trains over a
    ``('data', 'bag')`` mesh instead; without one, ``cfg.data_shards`` x
    ``cfg.bag_shards`` > 1 builds it over the visible cards. ``device=``
    pins the fold to one device (fold-parallel CV) and cannot combine with a
    mesh."""

    def __init__(self, cfg: TrainConfig, fold: int, results_dir: str | os.PathLike, writer=None, mesh=None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.fold = fold
        self.results_dir = Path(results_dir)
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self.writer = writer
        # a mesh owns placement itself; device= pins one fold to one device
        if device is not None and (mesh is not None or cfg.data_shards * cfg.bag_shards > 1):
            raise ValueError("device= (fold-parallel) cannot combine with mesh/data_shards/bag_shards")
        if mesh is None and cfg.data_shards * cfg.bag_shards > 1:
            from toad_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(cfg.data_shards, cfg.bag_shards)
        self.mesh = mesh
        if mesh is not None:
            from toad_tpu_torch.parallel.sharding import shard_batch

            self._put = lambda bd: shard_batch(bd, mesh)
            self.device = mesh.primary
        else:
            self._put = None
            self.device = resolve_device(device)
        # every fold starts from the same seed: the reference re-seeds with
        # args.seed before each fold
        self.model = ToadMIL(cfg.model, generator=seed_everything(cfg.seed)).to(self.device)
        self.optimizer = make_optimizer(cfg.optim, self.model.parameters())
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)  # dropout masks
        if cfg.debug_checks:
            from toad_tpu_torch.utils.debug import make_checked_step

            self.train_step = make_checked_step(self.model, self.optimizer, cfg.cls_loss_weight, cfg.site_loss_weight)
        else:
            self.train_step = make_train_step(self.model, self.optimizer, cfg.cls_loss_weight, cfg.site_loss_weight)
        self.eval_step = make_eval_step(self.model)
        self.eval_batches = 0  # batches of every eval pass so far
        self._launches_at_start = (cuda_pool.LAUNCHES, cuda_pool.PARTIAL_LAUNCHES, cuda_pool.COMBINE_LAUNCHES)

    @property
    def pool_kernel_launches(self) -> int:
        """Launches of the pooling kernel since this trainer was built (the
        counts are the process's: folds trained at once on several devices
        share them)."""
        return cuda_pool.LAUNCHES - self._launches_at_start[0]

    @property
    def partial_kernel_launches(self) -> tuple[int, int]:
        """(launches of the kernel's partial mode K1p, of the shard combine)
        since this trainer was built: a bag axis's eval passes."""
        return (cuda_pool.PARTIAL_LAUNCHES - self._launches_at_start[1],
                cuda_pool.COMBINE_LAUNCHES - self._launches_at_start[2])

    def _batch(self, b) -> dict[str, torch.Tensor]:
        """A batch as the step takes it: on the device, or placed over the mesh."""
        if self._put is not None:
            return self._put(batch_to_dict(b, "cpu"))
        return batch_to_dict(b, self.device)

    def _batcher(self, split, training: bool) -> BagBatcher:
        d = self.cfg.data
        if d.transfer_dtype == "int8":
            # int8 is an eval wire (evaluate_split int8=True): the train step
            # has no dequantization, so int8 rows would train as raw integers
            raise ValueError("transfer_dtype='int8' is eval-only; training supports 'auto'/'float32'/'bfloat16'")
        mode = ("weighted" if d.weighted_sample else "shuffle") if training else "sequential"
        return BagBatcher(
            split,
            batch_size=d.batch_size,
            bucket_sizes=d.bucket_sizes,
            mode=mode,
            seed=self.cfg.seed + self.fold * 1009,
            testing_frac=(d.testing_frac if training and d.testing_frac else None),
            max_bag_size=d.max_bag_size,
            prefetch=d.prefetch,
            native=d.native,
            # 'auto' resolves to a bf16 transfer only when the model computes
            # in bf16 (then casting on the host is numerically invisible)
            transfer_dtype=resolve_transfer_dtype(d.transfer_dtype, self.cfg.model.compute_dtype),
            # on CUDA the producer thread starts each batch's copy to the card; under a mesh the
            # batches stay on the host and shard_batch places each cell's slice
            device=self.device if self.mesh is None else None,
        )

    @property
    def ckpt_path(self) -> Path:
        return self.results_dir / checkpoint_name(self.fold)

    @property
    def resume_path(self) -> Path:
        return self.results_dir / f"s_{self.fold}_resume.pt"

    def _save_best(self) -> None:
        """The model as a reference-layout state_dict, the file
        ``load_params_any`` and ``serve --ckpt`` read."""
        save_checkpoint(self.ckpt_path, reference_state_dict(self.model.state_dict(), dropout=self.cfg.model.dropout))

    def _save_resume(self, epoch: int, stopper: EarlyStopping | None, best_saved: bool) -> None:
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
            "epoch": int(epoch),
            "best_saved": int(best_saved),
        }
        if stopper is not None:
            state["stopper"] = stopper.state_dict()
        save_checkpoint(self.resume_path, state)

    def _eval(self, batcher: BagBatcher) -> dict:
        self.model.eval()
        res = run_eval_pass(self.eval_step, batcher, self.cfg.model.n_classes, self.device, put=self._put)
        self.eval_batches += res["n_batches"]
        return res

    def train(self, train_split, val_split, test_split, log_fn: Callable[[str], None] = print):
        cfg = self.cfg
        if cfg.rss_restart_gb is not None and not cfg.resume:
            raise ValueError(
                "rss_restart_gb requires resume=True — a watermark restart "
                "without resume snapshots would lose all training progress"
            )
        n_classes = cfg.model.n_classes

        save_split_columnar(
            {
                "train": list(train_split.slide_ids),
                "val": list(val_split.slide_ids),
                "test": list(test_split.slide_ids),
            },
            self.results_dir / f"splits_{self.fold}.csv",
        )

        if cfg.data.patient_bags:
            # wrap once here so that indices, ids and labels stay patient-level
            # everywhere downstream; the snapshot above stays slide-level
            from toad_tpu_torch.data.wsi_dataset import PatientBagSplit

            train_split = PatientBagSplit(train_split)
            val_split = PatientBagSplit(val_split)
            test_split = PatientBagSplit(test_split)

        model = self.model
        log_fn(
            f"[fold {self.fold}] model params: {sum(p.numel() for p in model.parameters()):,} | "
            f"train {len(train_split)} / val {len(val_split)} / test {len(test_split)} slides | "
            f"device {torch.cuda.get_device_name(self.device) if self.device.type == 'cuda' else 'cpu'}"
            + (f" | mesh {self.mesh.shape}" if self.mesh is not None else "")
        )

        tracer = StepTracer(cfg.profile_dir, n_steps=10, device=self.device)
        train_batcher = self._batcher(train_split, training=True)
        val_batcher = self._batcher(val_split, training=False)
        test_batcher = self._batcher(test_split, training=False)

        stopper = EarlyStopping(cfg.patience, cfg.min_stop_epoch) if cfg.early_stopping else None
        best_saved = False
        start_epoch = 0

        if cfg.resume and recover_checkpoint(self.resume_path) is not None:
            state = restore_checkpoint(self.resume_path)
            model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            self.generator.set_state(state["generator"])
            start_epoch = int(state["epoch"]) + 1
            best_saved = bool(state["best_saved"])
            if stopper is not None and "stopper" in state:
                stopper.load_state_dict(state["stopper"])
            log_fn(f"[fold {self.fold}] resumed from epoch {start_epoch - 1} ({self.resume_path})")

        for epoch in range(start_epoch, cfg.max_epochs):
            t0 = time.perf_counter()
            train_batcher.set_epoch(epoch)
            model.train()
            cls_logger = AccuracyLogger(n_classes)
            site_logger = AccuracyLogger(2)
            sums = {"cls_loss_sum": 0.0, "site_loss_sum": 0.0, "n_bags": 0.0, "cls_correct": 0.0, "site_correct": 0.0}
            t_data = 0.0  # host time blocked on the input pipeline
            t_fetch = time.perf_counter()
            for b in train_batcher:
                t_data += time.perf_counter() - t_fetch
                packed = self.train_step(self._batch(b), self.generator)
                metrics = unpack_metrics(packed)  # the step's one device-to-host copy
                tracer.step()
                for k in sums:
                    sums[k] += metrics[k]
                cls_logger.log_batch(metrics["y_hat"], b.label, b.bag_mask)
                site_logger.log_batch(metrics["site_hat"], b.site, b.bag_mask)
                t_fetch = time.perf_counter()

            tracer.stop()
            n = max(sums["n_bags"], 1.0)
            tr_cls_loss = sums["cls_loss_sum"] / n
            tr_cls_err = 1.0 - sums["cls_correct"] / n
            dt = time.perf_counter() - t0
            data_frac = t_data / max(dt, 1e-9)
            log_fn(
                f"[fold {self.fold}] epoch {epoch}: train cls_loss {tr_cls_loss:.4f} "
                f"err {tr_cls_err:.4f} | {n / dt:.1f} slides/s (data wait {data_frac:.0%}), feed {train_batcher.feed_kind}"
            )
            self._write_scalars(
                "train",
                epoch,
                {
                    "cls_loss": tr_cls_loss,
                    "cls_error": tr_cls_err,
                    "site_loss": sums["site_loss_sum"] / n,
                    "site_error": 1.0 - sums["site_correct"] / n,
                    "data_wait_frac": data_frac,
                },
                cls_logger,
                site_logger,
            )

            val = self._eval(val_batcher)
            log_fn(
                f"[fold {self.fold}] epoch {epoch}: val cls_loss {val['cls_loss']:.4f} "
                f"err {val['cls_error']:.4f} auc {val['cls_auc']:.4f} site auc {val['site_auc']:.4f} | feed {val['feed']}"
            )
            # per-class TPR tallies for the val tag schema the reference emits every epoch
            val_cls_logger = AccuracyLogger(n_classes)
            val_cls_logger.log_batch(val["y_hat"], val["label"])
            val_site_logger = AccuracyLogger(2)
            val_site_logger.log_batch(val["site_hat"], val["site"])
            self._write_scalars(
                "val",
                epoch,
                {
                    "cls_loss": val["cls_loss"],
                    "cls_auc": val["cls_auc"],
                    "cls_error": val["cls_error"],
                    "site_loss": val["site_loss"],
                    "site_auc": val["site_auc"],
                    "site_error": val["site_error"],
                },
                val_cls_logger,
                val_site_logger,
            )

            if stopper is not None:
                if stopper(epoch, val["cls_loss"]):
                    self._save_best()
                    best_saved = True
                if stopper.early_stop:
                    log_fn(f"[fold {self.fold}] early stopping at epoch {epoch}")
                    break

            if cfg.resume and (epoch + 1) % cfg.resume_every == 0:
                self._save_resume(epoch, stopper, best_saved)

            if cfg.rss_restart_gb is not None:
                rss = profiling.host_rss_gb()
                if rss >= cfg.rss_restart_gb:
                    # snapshot NOW (resume_every may not have fired this
                    # epoch) so the re-exec'd process loses nothing
                    self._save_resume(epoch, stopper, best_saved)
                    log_fn(
                        f"[fold {self.fold}] host RSS {rss:.1f} GiB >= "
                        f"{cfg.rss_restart_gb:.1f} — snapshotting for restart"
                    )
                    raise HostRssWatermark(rss, cfg.rss_restart_gb, epoch)

        if stopper is not None and best_saved:
            model.load_state_dict(load_params_any(self.ckpt_path, cfg.model))
        else:
            self._save_best()

        val = self._eval(val_batcher)
        test = self._eval(test_batcher)
        log_fn(
            f"[fold {self.fold}] FINAL val: err {val['cls_error']:.4f} auc {val['cls_auc']:.4f} | "
            f"test: err {test['cls_error']:.4f} auc {test['cls_auc']:.4f} | feed val {val['feed']}, test {test['feed']}"
        )
        partial, combine = self.partial_kernel_launches
        log_fn(
            f"[fold {self.fold}] eval batches {self.eval_batches}, pooling kernel launches "
            f"{self.pool_kernel_launches}"
            + (f", partial-mode launches {partial}, combine launches {combine}" if self.mesh is not None else "")
        )

        patient_results = patient_results_from_pass(
            test, [test_split.slide_ids[int(idx)] for idx in test["indices"]]
        )

        if self.writer is not None:
            for key, v in (
                ("final/cls_val_error", val["cls_error"]),
                ("final/cls_val_auc", val["cls_auc"]),
                ("final/site_val_error", val["site_error"]),
                ("final/site_val_auc", val["site_auc"]),
                ("final/cls_test_error", test["cls_error"]),
                ("final/cls_test_auc", test["cls_auc"]),
                ("final/site_test_error", test["site_error"]),
                ("final/site_test_auc", test["site_auc"]),
            ):
                self.writer.add_scalar(key, v, 0)

        # Only now is the snapshot obsolete: a preemption during the final
        # restore and passes above must still resume, not retrain.
        if cfg.resume and recover_checkpoint(self.resume_path) is not None:
            self.resume_path.unlink()

        return {
            "results": patient_results,
            "cls_test_auc": test["cls_auc"],
            "cls_val_auc": val["cls_auc"],
            "cls_test_acc": 1.0 - test["cls_error"],
            "cls_val_acc": 1.0 - val["cls_error"],
            "site_test_auc": test["site_auc"],
            "site_val_auc": val["site_auc"],
            "site_test_acc": 1.0 - test["site_error"],
            "site_val_acc": 1.0 - val["site_error"],
            "params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "val": val,
            "test": test,
            "eval_batches": self.eval_batches,
            "pool_kernel_launches": self.pool_kernel_launches,
        }

    def _write_scalars(self, prefix: str, epoch: int, scalars: dict[str, float], cls_logger=None, site_logger=None):
        if self.writer is None:
            return
        for k, v in scalars.items():
            self.writer.add_scalar(f"{prefix}/{k}", v, epoch)
        if cls_logger is not None:
            for c in range(cls_logger.n_classes):
                acc, _, _ = cls_logger.get_summary(c)
                if acc is not None:
                    self.writer.add_scalar(f"{prefix}/class_{c}_tpr", acc, epoch)
        if site_logger is not None:
            for c in range(2):
                acc, _, _ = site_logger.get_summary(c)
                if acc is not None:
                    self.writer.add_scalar(f"{prefix}/site_{c}_tpr", acc, epoch)


def train_fold(cfg: TrainConfig, fold: int, splits, results_dir, writer=None, log_fn=print, device=None, mesh=None):
    trainer = FoldTrainer(cfg, fold, results_dir, writer, mesh=mesh, device=device)
    return trainer.train(*splits, log_fn=log_fn)
