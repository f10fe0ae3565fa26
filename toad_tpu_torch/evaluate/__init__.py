"""Evaluation: metrics, the shared eval pass, the engine, calibration."""

from toad_tpu_torch.evaluate.engine import EvalResult, evaluate_split
from toad_tpu_torch.evaluate.metrics import (
    AccuracyLogger,
    binary_auc,
    error_rate,
    macro_ovr_auc,
    micro_ovr_auc,
    ovr_aucs,
    topk_accuracy,
)

__all__ = [
    "AccuracyLogger",
    "binary_auc",
    "error_rate",
    "macro_ovr_auc",
    "micro_ovr_auc",
    "ovr_aucs",
    "topk_accuracy",
    "evaluate_split",
    "EvalResult",
]
