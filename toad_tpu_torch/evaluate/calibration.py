"""Temperature scaling of class probabilities (counterpart of
:func:`toad_tpu.evaluate.calibration.apply_temperature`)."""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def apply_temperature(probs: np.ndarray, temperature: float) -> np.ndarray:
    """softmax(log p / T): equivalent to softmax(logits / T) for the logits
    that produced ``probs`` (shift invariance of softmax)."""
    logp = np.log(np.clip(np.asarray(probs, np.float64), _EPS, None)) / float(temperature)
    logp -= logp.max(axis=1, keepdims=True)
    e = np.exp(logp)
    return e / e.sum(axis=1, keepdims=True)
