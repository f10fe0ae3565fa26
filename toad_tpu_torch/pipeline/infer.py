"""Per-slide prediction record (counterpart of
:class:`toad_tpu.pipeline.infer.SlidePrediction`)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SlidePrediction(NamedTuple):
    """Per-slide outputs, mirroring the reference results dict, plus ranked origins."""

    y_hat: int
    y_prob: np.ndarray  # [n_classes]
    site_hat: int
    site_prob: np.ndarray  # [2]
    attention: np.ndarray  # [N] raw origin-task attention over real patches
    site_attention: np.ndarray  # [N] raw site-task attention
    topk: list[tuple[int, float]]  # (class index, prob) best-first
