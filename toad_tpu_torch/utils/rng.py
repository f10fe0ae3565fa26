"""Determinism helpers (reference ``seed_torch``, ``main_mtl_concat.py:109-121``).

PyTorch counterpart of :mod:`toad_tpu.utils.rng`. Python's and NumPy's global
generators (split generation, samplers) are seeded as there; what draws
random tensors inside the package (initial weights, dropout masks) takes an
explicit ``torch.Generator``, which this returns seeded, and never relies on
``torch.manual_seed``.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """Seed Python's and NumPy's global generators; returns a generator on
    ``device`` seeded with ``seed``."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
