"""Shared no-grad evaluation pass: one step per batch + host-side metric assembly.

PyTorch counterpart of :mod:`toad_tpu.evaluate.runner`, used by the
trainer's epoch validation and final passes (reference
``validate``/``summary``). The step runs the model's eval forward under
``torch.inference_mode()`` in classification mode (no attention returned),
which on CUDA is the hand-written pooling kernel; the int8 step runs the
quantized forward, on CUDA the hand-written int8 pooling kernel.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from toad_tpu_torch.data.batching import BagBatch, BagBatcher
from toad_tpu_torch.evaluate.metrics import binary_auc, ovr_aucs
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops.quantize import quantize_rows
from toad_tpu_torch.parallel.sharding import ShardedBatch


def batch_to_dict(b: BagBatch, device: str | torch.device) -> dict[str, torch.Tensor]:
    """The batch as tensors on ``device``. A batch that the batcher's device
    feed already placed is taken as it is, after the current stream has been
    told to wait for its copy; a host batch is copied here."""
    device = torch.device(device)
    b.wait()

    def put(a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        return t.to(device, non_blocking=True)

    d = {
        "features": put(b.features),
        "patch_mask": put(b.patch_mask),
        "bag_mask": put(b.bag_mask),
        "label": put(b.label).long(),
        "site": put(b.site).long(),
        "sex": put(b.sex),
    }
    if b.scales is not None:  # int8 wire: rows quantized in the producer thread
        d["scales"] = put(b.scales)
    return d


def make_eval_step(model: ToadMIL, int8: bool = False):
    """``step(batch_dict) -> dict`` of per-bag outputs, all on the model's
    device, computed without gradients.

    ``int8=True`` runs the quantized forward (``ToadMIL.forward_int8``): rows
    and scales as the int8 wire brought them, or quantized here on the device
    when the batch is float; the trunk and gate GEMMs run int8, the heads and
    metrics stay f32. The model quantizes its pooling weights once and again
    whenever a weight changes, so the step follows a checkpoint loaded into
    the model later. An un-gated model fails here, not at the first batch."""
    if int8:
        with torch.inference_mode():
            model.int8_operands()  # quantizes the weights now; raises for an un-gated model

    def step(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        with torch.inference_mode():
            if isinstance(batch, ShardedBatch):  # placed on a mesh: each cell pools on its device
                out = model.forward_sharded(batch, need_attention=False, int8=int8)
            elif int8:
                if "scales" in batch:
                    xq, sx = batch["features"], batch["scales"]
                else:
                    xq, sx = quantize_rows(batch["features"])
                out = model.forward_int8(xq, sx, batch["patch_mask"], batch["sex"], need_attention=False)
            else:
                out = model(
                    batch["features"], batch["patch_mask"], batch["sex"],
                    train=False, need_attention=False,  # eval discards attention: the kernel writes no [B, T, N] scores
                )
            return {
                "y_prob": out.y_prob,
                "y_hat": out.y_hat,
                "site_prob": out.site_prob,
                "site_hat": out.site_hat,
                "cls_ce": F.cross_entropy(out.logits, batch["label"], reduction="none"),
                "site_ce": F.cross_entropy(out.site_logits, batch["site"], reduction="none"),
            }

    return step


def run_eval_pass(eval_step, batcher: BagBatcher, n_classes: int, device: str | torch.device, put=None):
    """One no-grad pass: per-slide probs/preds + mean losses + AUCs on the
    host; also the pass's batches, the bytes its batches sent over the wire,
    its seconds and those of them spent waiting for the batcher, and which
    feed filled the batches (``'native'`` or ``'numpy'``).

    ``put`` optionally places each host batch itself (a mesh's
    :func:`~toad_tpu_torch.parallel.sharding.shard_batch`); without it each
    batch goes to ``device``."""
    probs, labels, sites, site_probs, preds, site_preds, sexes, indices = [], [], [], [], [], [], [], []
    cls_loss_sum = 0.0
    site_loss_sum = 0.0
    n_total = 0
    n_batches = 0
    wire_bytes = 0
    t_data = 0.0  # host time blocked on the input pipeline
    t0 = t_fetch = time.perf_counter()
    for b in batcher:
        t_data += time.perf_counter() - t_fetch
        n_batches += 1
        wire_bytes += b.wire_bytes
        out = eval_step(put(batch_to_dict(b, "cpu")) if put is not None else batch_to_dict(b, device))
        keep = b.bag_mask > 0
        out = {k: v.cpu().numpy() for k, v in out.items()}
        probs.append(out["y_prob"][keep])
        site_probs.append(out["site_prob"][keep])
        preds.append(out["y_hat"][keep])
        site_preds.append(out["site_hat"][keep])
        labels.append(b.label[keep])
        sites.append(b.site[keep])
        sexes.append(b.sex[keep])
        indices.append(b.indices[keep])
        cls_loss_sum += float(out["cls_ce"][keep].sum())
        site_loss_sum += float(out["site_ce"][keep].sum())
        n_total += int(keep.sum())
        t_fetch = time.perf_counter()
    t_data += time.perf_counter() - t_fetch  # the wait that ended the iteration
    seconds = time.perf_counter() - t0

    probs = np.concatenate(probs) if probs else np.zeros((0, n_classes))
    res = {
        "y_prob": probs,
        "site_prob": np.concatenate(site_probs) if site_probs else np.zeros((0, 2)),
        "y_hat": np.concatenate(preds) if preds else np.zeros((0,), np.int32),
        "site_hat": np.concatenate(site_preds) if site_preds else np.zeros((0,), np.int32),
        "label": np.concatenate(labels) if labels else np.zeros((0,), np.int32),
        "site": np.concatenate(sites) if sites else np.zeros((0,), np.int32),
        "sex": np.concatenate(sexes) if sexes else np.zeros((0,), np.int32),
        "indices": np.concatenate(indices) if indices else np.zeros((0,), np.int64),
        "n": n_total,
        "n_batches": n_batches,
        "wire_bytes": wire_bytes,
        "seconds": seconds,
        "data_wait_s": t_data,
        "feed": batcher.feed_kind,
        "cls_loss": cls_loss_sum / max(n_total, 1),
        "site_loss": site_loss_sum / max(n_total, 1),
    }
    res["cls_error"] = float(1.0 - (res["y_hat"] == res["label"]).mean()) if n_total else 1.0
    res["site_error"] = float(1.0 - (res["site_hat"] == res["site"]).mean()) if n_total else 1.0
    if n_total:
        if n_classes == 2:
            res["cls_auc"] = binary_auc(res["label"], res["y_prob"][:, 1])
            res["cls_aucs"] = np.array([])
        else:
            res["cls_aucs"] = ovr_aucs(res["label"], res["y_prob"], n_classes)
            res["cls_auc"] = float(np.nanmean(res["cls_aucs"]))
        res["site_auc"] = binary_auc(res["site"], res["site_prob"][:, 1])
    else:
        res["cls_auc"] = float("nan")
        res["cls_aucs"] = np.array([])
        res["site_auc"] = float("nan")
    return res


def patient_results_from_pass(res: dict, slide_ids) -> dict:
    """Reference-style per-slide results dict (the reference's ``summary``).
    Row i of ``res`` must correspond to ``slide_ids[i]``."""
    out = {}
    for i, sid in enumerate(slide_ids):
        sid = str(sid)
        out[sid] = {
            "slide_id": sid,
            "cls_prob": res["y_prob"][i : i + 1],
            "cls_label": int(res["label"][i]),
            "site_prob": res["site_prob"][i : i + 1],
            "site_label": int(res["site"][i]),
        }
    return out
