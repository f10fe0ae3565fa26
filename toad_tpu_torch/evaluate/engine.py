"""Evaluation engine: checkpoint -> per-slide predictions -> metrics + CSVs.

PyTorch counterpart of :mod:`toad_tpu.evaluate.engine`, with the reference
eval stack's capabilities (``utils/eval_utils_mtl_concat.py:19-177`` +
``eval_mtl_concat.py:108-149``): top-1/3/5 accuracy, per-class OVR AUCs with
macro or micro averaging, the per-slide table (``slide_id, sex, Y, Y_hat,
site, site_hat, p_0..p_{C-1}, site_p``), and the -1 sentinel when only one
class is present. No pandas: the per-slide table is a mapping of columns,
written as the file pandas would write.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from toad_tpu_torch.config import DEFAULT_BUCKETS, ModelConfig
from toad_tpu_torch.data.batching import BagBatcher, resolve_transfer_dtype
from toad_tpu_torch.evaluate.metrics import binary_auc, bootstrap_cis, micro_ovr_auc, ovr_aucs, topk_accuracy
from toad_tpu_torch.evaluate.runner import make_eval_step, patient_results_from_pass, run_eval_pass
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.utils.io import write_columns_csv


def topk_ladder(n_classes: int) -> tuple[int, ...]:
    """The k's reported for a task of ``n_classes``: a top-k at or beyond the
    class count would be the constant 1."""
    return (1, 3, 5) if n_classes > 5 else ((1, 3) if n_classes > 2 else (1,))


def cls_auc_with_sentinel(labels: np.ndarray, probs: np.ndarray, n_classes: int, micro_average: bool):
    """(cls AUC, per-class AUCs) with the reference's sentinels
    (``eval_utils:131-132, 157-160``): -1 when one class only is present,
    the binary AUC for two classes, else macro (nanmean of OVR) or micro."""
    if len(np.unique(labels)) <= 1:
        return -1.0, np.array([])
    if n_classes == 2:
        return binary_auc(labels, probs[:, 1]), np.array([])
    aucs = ovr_aucs(labels, probs, n_classes)
    return (micro_ovr_auc(labels, probs, n_classes) if micro_average else float(np.nanmean(aucs))), aucs


@dataclass
class EvalResult:
    """One split's evaluation. ``df`` is the per-slide table as a plain
    ordered mapping of column name -> numpy array (where the JAX package
    holds a DataFrame): ``slide_id`` strings; ``sex``, ``Y``, ``site``
    float64; ``Y_hat``, ``site_hat`` integers; ``p_c`` and ``site_p`` the
    step's float32. ``stats`` describes the pass: its batches, seconds,
    seconds spent waiting for data, the wire, the bytes it carried and the
    feed that filled its batches."""

    df: dict[str, np.ndarray]
    cls_auc: float
    cls_aucs: np.ndarray
    cls_error: float
    site_auc: float
    site_error: float
    topk: dict[int, float]
    patient_results: dict[str, Any] = field(default_factory=dict)
    stats: dict[str, Any] = field(default_factory=dict)

    @property
    def cls_acc(self) -> float:
        return 1.0 - self.cls_error

    @property
    def site_acc(self) -> float:
        return 1.0 - self.site_error

    def probs(self) -> np.ndarray:
        """[N, C] class probabilities, the ``p_*`` columns side by side."""
        return np.stack([v for k, v in self.df.items() if k.startswith("p_")], axis=1)

    def write_csv(self, path: str | os.PathLike) -> None:
        """The per-slide table as ``DataFrame.to_csv(path, index=False)`` writes it."""
        write_columns_csv(path, self.df)


def evaluate_split(
    model: ToadMIL,
    split,
    *,
    n_classes: int | None = None,
    micro_average: bool = False,
    batch_size: int = 1,
    bucket_sizes=None,
    max_bag_size: int | None = None,
    eval_step=None,
    int8: bool = False,
    transfer_dtype: str = "auto",
    device: str | torch.device | None = None,
    native: str = "auto",
    mesh=None,
) -> EvalResult:
    """Run a full no-grad pass over ``split`` with the model's own weights and
    assemble the reference-schema outputs.

    ``device`` moves the model (and every batch) there first; ``None`` keeps
    the model where the caller put it: the placement hook fold-parallel
    evaluation uses to run one fold per device (``eval --fold_devices``).
    ``mesh`` (a :class:`~toad_tpu_torch.parallel.mesh.DeviceMesh`) runs the
    pass over a ``('data', 'bag')`` mesh instead: the model moves to its
    first device and every batch is placed over it (``shard_batch``).
    ``native`` is the batcher's feed: 'auto' (as the JAX engine's batcher;
    the ``eval`` CLI's), 'on' or 'off' (numpy, which needs no C++
    compiler)."""
    n_classes = n_classes if n_classes is not None else model.config.n_classes
    put = None
    if mesh is not None:
        from toad_tpu_torch.parallel.sharding import shard_batch

        if device is not None:
            raise ValueError("device= cannot combine with mesh= (the mesh owns placement)")
        device = mesh.primary
        put = lambda bd: shard_batch(bd, mesh)  # noqa: E731
    if device is not None:
        model = model.to(device)
    device = next(model.parameters()).device
    # The int8 wire ships quantized rows and scales, which only a step built
    # here knows how to consume: a caller's eval_step (a reused float step)
    # must keep getting float features, or it would run the raw -127..127
    # integers through the model.
    own_step = eval_step is None
    if transfer_dtype == "int8" and not (int8 and own_step):
        raise ValueError(
            "transfer_dtype='int8' requires int8=True with an engine-built step "
            "(a float step would consume the raw quantized integers)"
        )
    model.eval()
    if own_step:
        eval_step = make_eval_step(model, int8=int8)
    # 'auto': the int8 wire for quantized eval (rows quantized in the producer
    # thread: a quarter of the host-to-device bytes, the same quantizer as on
    # the device); else bf16 when (and only when) the model computes in bf16,
    # where the host-side cast is numerically invisible. An explicit
    # 'bfloat16' with int8 also resolves to the int8 wire: bf16 rows into an
    # int8 step would round twice (f32 -> bf16 -> int8); quantizing straight
    # from f32 in the producer is exact and fewer bytes.
    wire = ("int8" if int8 and own_step and transfer_dtype in ("auto", "bfloat16")
            else resolve_transfer_dtype(transfer_dtype, model.config.compute_dtype))
    batcher = BagBatcher(
        split,
        batch_size=batch_size,
        bucket_sizes=bucket_sizes if bucket_sizes is not None else DEFAULT_BUCKETS,
        mode="sequential",
        max_bag_size=max_bag_size,
        native=native,
        transfer_dtype=wire,
        # on CUDA the producer thread starts each batch's copy to the card; a mesh places its batches itself
        device=device if put is None else None,
    )
    res = run_eval_pass(eval_step, batcher, n_classes, device, put=put)

    labels, probs = res["label"], res["y_prob"]
    cls_auc, cls_aucs = cls_auc_with_sentinel(labels, probs, n_classes, micro_average)
    site_auc = -1.0 if len(np.unique(res["site"])) <= 1 else binary_auc(res["site"], res["site_prob"][:, 1])

    ks = topk_ladder(n_classes)
    topk = topk_accuracy(probs, labels, ks) if res["n"] else {k: float("nan") for k in ks}

    order = np.argsort(res["indices"], kind="stable")  # back into the split's order
    slide_ids = np.asarray(split.slide_ids)[res["indices"][order]]
    cols: dict[str, np.ndarray] = {
        "slide_id": slide_ids,
        "sex": res["sex"][order].astype(np.float64),
        "Y": labels[order].astype(np.float64),
        "Y_hat": res["y_hat"][order],
        "site": res["site"][order].astype(np.float64),
        "site_hat": res["site_hat"][order],
    }
    for c in range(n_classes):
        cols[f"p_{c}"] = probs[order, c]
    cols["site_p"] = res["site_prob"][order, 1]

    patient_results = patient_results_from_pass(
        {"y_prob": probs[order], "label": labels[order], "site_prob": res["site_prob"][order], "site": res["site"][order]},
        slide_ids,
    )

    return EvalResult(
        df=cols,
        cls_auc=float(cls_auc),
        cls_aucs=cls_aucs,
        cls_error=res["cls_error"],
        site_auc=float(site_auc),
        site_error=res["site_error"],
        topk=topk,
        patient_results=patient_results,
        stats={"transfer_dtype": wire, "n": res["n"],
               **{k: res[k] for k in ("n_batches", "wire_bytes", "seconds", "data_wait_s", "feed")}},
    )


def bootstrap_result_cis(
    res: EvalResult,
    n_classes: int,
    *,
    n_boot: int = 1000,
    seed: int = 1,
    alpha: float = 0.05,
    micro_average: bool = False,
) -> dict[str, dict[str, float]]:
    """Percentile-bootstrap CIs for an :class:`EvalResult`, resampling its
    per-slide table (see :func:`toad_tpu_torch.evaluate.metrics.bootstrap_cis`)."""
    df = res.df
    return bootstrap_cis(
        df["Y"],
        np.stack([df[f"p_{c}"] for c in range(n_classes)], axis=1),
        df["site"],
        df["site_p"],
        preds=df["Y_hat"],
        n_boot=n_boot,
        seed=seed,
        alpha=alpha,
        micro_average=micro_average,
    )


def evaluate_checkpoint(
    ckpt_path: str | Path,
    split,
    model_cfg: ModelConfig,
    *,
    micro_average: bool = False,
    batch_size: int = 1,
    max_bag_size: int | None = None,
    int8: bool = False,
    bucket_sizes=None,
    transfer_dtype: str = "auto",
    device: str | torch.device | None = None,
    mesh=None,
) -> EvalResult:
    """Load a reference-layout ``s_{fold}_checkpoint.pt`` (what the trainer
    saves and a reference user's models dir holds) and evaluate it on
    ``device``: the card when ``None``, which raises where there is none;
    or over ``mesh`` (see :func:`evaluate_split`)."""
    from toad_tpu_torch.train.checkpoint import load_params_any
    from toad_tpu_torch.train.loop import resolve_device

    if mesh is None:
        device = resolve_device(device)
    model = ToadMIL(model_cfg)
    model.load_state_dict(load_params_any(ckpt_path, model_cfg))
    return evaluate_split(
        model,
        split,
        micro_average=micro_average,
        batch_size=batch_size,
        max_bag_size=max_bag_size,
        int8=int8,
        bucket_sizes=bucket_sizes,
        # 'float32' sends the rows as they are stored; the 'auto' picks (bf16,
        # int8) can shift border values
        transfer_dtype=transfer_dtype,
        device=device,
        mesh=mesh,
    )
