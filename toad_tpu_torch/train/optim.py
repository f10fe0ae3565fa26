"""Optimizer factory with the reference's torch semantics.

Reference (``utils/utils.py:63-70``): ``optim.Adam(lr, weight_decay)`` or
``optim.SGD(lr, momentum=0.9, weight_decay)``. torch's ``weight_decay`` is
L2 added to the gradient before the moment updates (not decoupled AdamW),
which is what the JAX package's optax chains spell out
(:mod:`toad_tpu.train.optim`): the two agree step for step.
"""

from __future__ import annotations

from typing import Iterable

import torch

from toad_tpu_torch.config import OptimConfig


def make_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    if cfg.name == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps, weight_decay=cfg.weight_decay)
    if cfg.name == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    raise NotImplementedError(f"optimizer {cfg.name!r}")
