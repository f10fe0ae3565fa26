"""End-to-end slide inference: patches -> embed -> attention-pool -> predict.

PyTorch counterpart of :mod:`toad_tpu.pipeline.infer`. One slide at a time:
the bag is padded to the configured bucket (the training batcher's policy,
head-truncated past the largest bucket), goes through the model once with
its per-patch attention (the pooling kernel's scored mode on CUDA: K1 in the
model's compute dtype, K2 with ``int8``; the plain version on the CPU), and
comes back as a :class:`SlidePrediction` whose raw attention feeds heatmap
rendering (:mod:`toad_tpu_torch.pipeline.heatmap`).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from toad_tpu_torch.config import DEFAULT_BUCKETS, ModelConfig
from toad_tpu_torch.data.batching import PAD_SCALE, _pad_bag, bucket_for
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops.quantize import quantize_rows_np


class SlidePrediction(NamedTuple):
    """Per-slide outputs, mirroring the reference results dict, plus ranked origins."""

    y_hat: int
    y_prob: np.ndarray  # [n_classes]
    site_hat: int
    site_prob: np.ndarray  # [2]
    attention: np.ndarray  # [N] raw origin-task attention over real patches
    site_attention: np.ndarray  # [N] raw site-task attention
    topk: list[tuple[int, float]]  # (class index, prob) best-first

    def top_labels(self, inv_label_dict: dict[int, str] | None, k: int = 3):
        out = []
        for idx, p in self.topk[:k]:
            name = inv_label_dict.get(idx, str(idx)) if inv_label_dict else str(idx)
            out.append((name, p))
        return out


class SlideInference:
    """A checkpoint's model on one device, run one bag at a time.

    ``params`` is the model's state_dict (for example from
    :func:`toad_tpu_torch.train.checkpoint.load_params_any`). ``temperature``
    scales the class logits by 1/T before the softmax (the T fitted by
    ``eval --calibrate``); argmax and top-k order do not move, and the site
    probabilities stay at T = 1. ``device`` defaults to the card; asking for
    CUDA where there is none raises."""

    def __init__(
        self,
        params: Mapping[str, torch.Tensor],
        model_cfg: ModelConfig,
        bucket_sizes: Sequence[int] | None = None,
        int8: bool = False,
        temperature: float = 1.0,
        device: str | torch.device = "cuda",
    ):
        from toad_tpu_torch.train.loop import resolve_device

        if not temperature > 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.device = resolve_device(device)
        self.config = model_cfg
        self.int8 = int8
        self.temperature = float(temperature)
        self.buckets = tuple(sorted(DEFAULT_BUCKETS if bucket_sizes is None else bucket_sizes))
        self.model = self.build_model(params)

    def build_model(self, params: Mapping[str, torch.Tensor]) -> ToadMIL:
        """One :class:`ToadMIL` holding ``params`` on this object's device.
        It packs (or quantizes) its kernel operands at its first forward and
        keeps them."""
        model = ToadMIL(self.config)
        model.load_state_dict(params)
        return model.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, ckpt_path: str | os.PathLike, model_cfg: ModelConfig, **kw) -> "SlideInference":
        """A reference-layout ``s_{fold}_checkpoint.pt`` (the loading policy of
        :func:`toad_tpu_torch.train.checkpoint.load_params_any`)."""
        from toad_tpu_torch.train.checkpoint import load_params_any

        return cls(load_params_any(ckpt_path, model_cfg), model_cfg, **kw)

    def predict(self, features: np.ndarray, sex: int) -> SlidePrediction:
        """One bag [N, D] -> prediction. N is padded up to the nearest bucket;
        bags longer than the largest bucket are head-truncated to it (the
        training batcher's policy)."""
        return self._finish(*self._run(self.model, features, sex))

    def predict_quantized(self, xq_rows: np.ndarray, sx_rows: np.ndarray, sex: int) -> SlidePrediction:
        """Pre-quantized rows [n, D] int8 + [n] f32 scales -> prediction,
        without a host quantization pass (bags stored with
        :func:`toad_tpu_torch.data.bags.save_int8_bag` feed this directly).
        int8 mode only."""
        return self._finish(*self._run_quantized(self.model, xq_rows, sx_rows, sex))

    def _run(self, model: ToadMIL, features: np.ndarray, sex: int):
        """(logits, site logits, raw attention [1, 2, bucket], real rows) of one
        bag through ``model``, on the host."""
        bucket = bucket_for(int(features.shape[0]), self.buckets)
        feats32 = np.asarray(features, np.float32)
        n = min(int(feats32.shape[0]), bucket)  # real rows (the attention's slice)
        if self.int8:
            # only the real (head-truncated) rows are quantized, then the int8
            # array is padded: the serving batcher's policy
            return self._run_quantized(model, *quantize_rows_np(feats32[:n]), sex)
        bag, bag_mask = _pad_bag(feats32, bucket)
        x = torch.from_numpy(bag)[None]
        if self.config.compute_dtype == "bfloat16":
            # the bf16 wire: the model casts to bf16 on the device anyway, and
            # the cast rounds to nearest even on either side of the copy
            x = x.to(torch.bfloat16)
        with torch.inference_mode():
            out = model(x.to(self.device), torch.from_numpy(bag_mask)[None].to(self.device), self._sex(sex),
                        need_attention=True)
        return out.logits.cpu(), out.site_logits.cpu(), out.attention.cpu(), n

    def _run_quantized(self, model: ToadMIL, xq_rows: np.ndarray, sx_rows: np.ndarray, sex: int):
        if not self.int8:
            raise ValueError("predict_quantized requires SlideInference(int8=True)")
        bucket = bucket_for(int(xq_rows.shape[0]), self.buckets)
        n = min(int(xq_rows.shape[0]), bucket)
        xq = np.zeros((1, bucket, xq_rows.shape[1]), np.int8)
        xq[0, :n] = xq_rows[:n]
        sx = np.full((1, bucket), PAD_SCALE, np.float32)
        sx[0, :n] = np.asarray(sx_rows[:n], np.float32)
        mask = np.zeros((1, bucket), np.float32)
        mask[0, :n] = 1.0
        dev = self.device
        with torch.inference_mode():
            out = model.forward_int8(torch.from_numpy(xq).to(dev), torch.from_numpy(sx).to(dev),
                                     torch.from_numpy(mask).to(dev), self._sex(sex), need_attention=True)
        return out.logits.cpu(), out.site_logits.cpu(), out.attention.cpu(), n

    def _sex(self, sex: int) -> torch.Tensor:
        return torch.tensor([int(sex)], dtype=torch.int32).to(self.device)

    def _finish(self, logits: torch.Tensor, site_logits: torch.Tensor, attention: torch.Tensor, n: int) -> SlidePrediction:
        y_prob = torch.softmax(logits[0].float() / self.temperature, dim=-1).numpy()
        site_prob = torch.softmax(site_logits[0].float(), dim=-1).numpy()
        # argmax for y_hat (ties to the lowest index, as the eval engine's) and
        # a stable sort for the ranking, so that predict() and a batch eval
        # never disagree on tied probabilities
        order = np.argsort(-y_prob, kind="stable")
        attn = attention.numpy()
        return SlidePrediction(
            y_hat=int(y_prob.argmax()),
            y_prob=y_prob,
            site_hat=int(site_prob.argmax()),
            site_prob=site_prob,
            attention=attn[0, 0, :n],
            site_attention=attn[0, 1, :n],
            topk=[(int(i), float(y_prob[i])) for i in order],
        )


class EnsembleInference:
    """Average-of-folds ensemble: the mean softmax over k fold checkpoints.

    Each member is its own :class:`ToadMIL` on the device with its own packed
    kernel operands, so a slide costs one pooling-kernel launch (K1, or K2
    with ``int8``) per member; nothing is compiled, so the JAX package's
    "one compiled program for every member" has no counterpart here.

    Combination rule: each member's temperature-scaled class softmax, then
    the arithmetic mean; argmax and top-k rank the mean. The site
    probabilities are the mean of the members' site softmax. Attention comes
    back as the mean of the members' softmaxed pooling weights over the real
    rows, in float64 (raw attention logits are not comparable across
    members)."""

    def __init__(
        self,
        params_list: Sequence[Mapping[str, torch.Tensor]],
        model_cfg: ModelConfig,
        bucket_sizes: Sequence[int] | None = None,
        int8: bool = False,
        temperature: float = 1.0,
        device: str | torch.device = "cuda",
    ):
        if not params_list:
            raise ValueError("EnsembleInference needs at least one checkpoint")
        self._inf = SlideInference(params_list[0], model_cfg, bucket_sizes=bucket_sizes, int8=int8,
                                   temperature=temperature, device=device)
        self.members = [self._inf.model] + [self._inf.build_model(p) for p in params_list[1:]]

    @classmethod
    def from_checkpoints(
        cls, ckpt_paths: Sequence[str | os.PathLike], model_cfg: ModelConfig, **kw
    ) -> "EnsembleInference":
        """Each path a reference-layout ``s_{fold}_checkpoint.pt``."""
        from toad_tpu_torch.train.checkpoint import load_params_any

        return cls([load_params_any(p, model_cfg) for p in ckpt_paths], model_cfg, **kw)

    @classmethod
    def from_models_dir(
        cls, models_dir: str | os.PathLike, model_cfg: ModelConfig, **kw
    ) -> "EnsembleInference":
        """Every ``s_{k}_checkpoint`` member of a training results dir (the
        layout ``cli/train.py`` writes), sorted by fold index."""
        found = find_fold_checkpoints(models_dir)
        if not found:
            raise FileNotFoundError(f"no s_<k>_checkpoint members under {models_dir}")
        return cls.from_checkpoints([p for _, p in found], model_cfg, **kw)

    @classmethod
    def from_spec(
        cls, ckpt: str | os.PathLike, model_cfg: ModelConfig, **kw
    ) -> "EnsembleInference":
        """``--ckpt`` of ``predict/infer --ensemble``: a path that exists on
        disk is a training results dir (every ``s_<k>_checkpoint`` becomes a
        member); otherwise a comma-separated list of member checkpoints. The
        existence check runs first, so that a directory whose name holds a
        comma is never read as a list."""
        ckpt = os.fspath(ckpt)
        if "," in ckpt and not os.path.exists(ckpt):
            return cls.from_checkpoints(
                [s.strip() for s in ckpt.split(",") if s.strip()], model_cfg, **kw
            )
        return cls.from_models_dir(ckpt, model_cfg, **kw)

    @property
    def int8(self) -> bool:
        return self._inf.int8

    @property
    def buckets(self):
        return self._inf.buckets

    @property
    def device(self) -> torch.device:
        return self._inf.device

    def predict(self, features: np.ndarray, sex: int) -> SlidePrediction:
        return self._combine([self._inf._run(m, features, sex) for m in self.members])

    def predict_quantized(self, xq_rows: np.ndarray, sx_rows: np.ndarray, sex: int) -> SlidePrediction:
        return self._combine([self._inf._run_quantized(m, xq_rows, sx_rows, sex) for m in self.members])

    def _combine(self, runs) -> SlidePrediction:
        preds = [self._inf._finish(*run) for run in runs]
        y_prob = np.mean([p.y_prob for p in preds], axis=0)
        site_prob = np.mean([p.site_prob for p in preds], axis=0)

        def _mean_weights(key: str) -> np.ndarray:
            # softmax each member's raw attention over the real rows, then the mean
            ws = []
            for p in preds:
                a = np.asarray(getattr(p, key), np.float64)
                a = np.exp(a - a.max())
                ws.append(a / a.sum())
            return np.mean(ws, axis=0)

        order = np.argsort(-y_prob, kind="stable")
        return SlidePrediction(
            y_hat=int(y_prob.argmax()),
            y_prob=y_prob,
            site_hat=int(site_prob.argmax()),
            site_prob=site_prob,
            attention=_mean_weights("attention"),
            site_attention=_mean_weights("site_attention"),
            topk=[(int(i), float(y_prob[i])) for i in order],
        )


def find_fold_checkpoints(models_dir: str | os.PathLike) -> list[tuple[int, Path]]:
    """``(fold, path)`` for every ``s_{k}_checkpoint[.pt]`` in a results dir,
    sorted by fold, one per fold (or the ensemble mean would weight a fold
    twice). Where a fold has both an Orbax directory and a ``.pt``, the
    ``.pt`` is taken, since this package cannot read Orbax; the JAX package
    takes the directory there. A fold with only a directory is kept and
    raises :func:`~toad_tpu_torch.train.checkpoint.load_params_any`'s
    message, which names the conversion."""
    best: dict[int, Path] = {}
    for p in Path(models_dir).iterdir():
        m = re.fullmatch(r"s_(\d+)_checkpoint(\.pt)?", p.name)
        if m:
            fold = int(m.group(1))
            cur = best.get(fold)
            if cur is None or (m.group(2) and not cur.name.endswith(".pt")):
                best[fold] = p
    return sorted(best.items())


def infer_patch_file(
    embedder,
    inference: SlideInference | EnsembleInference,
    patch_file: str | os.PathLike,
    sex: int,
) -> tuple[SlidePrediction, np.ndarray | None]:
    """The whole chain for one slide: a patch file (``.h5`` or ``.npz``,
    :func:`~toad_tpu_torch.pipeline.featurize.read_patch_file`) -> features
    -> prediction. Returns (prediction, coords) for heatmap rendering."""
    from toad_tpu_torch.pipeline.featurize import read_patch_file

    f, imgs, coords = read_patch_file(patch_file)
    try:
        feats = embedder.embed_all(imgs)
    finally:
        f.close()
    pred = inference.predict(feats, sex)
    return pred, _align_coords(coords, pred)


def infer_feature_bag(
    inference: SlideInference | EnsembleInference,
    bag_path: str | os.PathLike,
    sex: int,
) -> tuple[SlidePrediction, np.ndarray | None]:
    """Inference straight from a feature bag (.pt/.h5/.npy/.npz). int8 stores
    (:func:`~toad_tpu_torch.data.bags.save_int8_bag`) feed the int8 path
    without a host requantization pass; in f32 mode they dequantize."""
    from toad_tpu_torch.data.bags import load_bag, load_bag_quantized

    if inference.int8:
        q = load_bag_quantized(bag_path)
        if q is not None:
            xq, sx, coords = q
            pred = inference.predict_quantized(xq, sx, sex)
            return pred, _align_coords(coords, pred)
    feats, coords = load_bag(bag_path, with_coords=True)
    pred = inference.predict(np.asarray(feats, np.float32), sex)
    return pred, _align_coords(coords, pred)


def _align_coords(coords: np.ndarray | None, pred: SlidePrediction) -> np.ndarray | None:
    """Keep coords in lockstep with the prediction's attention: predict()
    head-truncates bags longer than the largest bucket, and a coords array
    longer than the attention would corrupt attention exports and crash
    heatmap rendering."""
    if coords is not None and len(coords) > len(pred.attention):
        coords = coords[: len(pred.attention)]
    return coords
