"""Checkpoint loading for the port.

Counterpart of the ``.pt`` branch of
:func:`toad_tpu.train.checkpoint.load_params_any`: a reference-layout
``s_{fold}_checkpoint.pt`` (as the reference writes it, or as ``python -m
toad_tpu export`` converts an Orbax checkpoint) becomes the port's
state_dict. Orbax directories need the JAX stack and are not read here.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.models.interop import state_dict_from_reference


def load_params_any(ckpt_path: str | os.PathLike, model_cfg: ModelConfig | None = None) -> dict[str, torch.Tensor]:
    """The port's state_dict from a reference ``.pt`` checkpoint, with a
    ``.pt`` suffix fallback for bare names."""
    p = Path(ckpt_path)
    if p.is_dir():
        raise ValueError(
            f"{p} is an Orbax checkpoint directory, which this package cannot read; "
            f"convert it where toad_tpu runs: python -m toad_tpu export --ckpt {p} --out s_k_checkpoint.pt"
        )
    f = p if p.exists() else p.with_suffix(".pt")
    if not f.exists():
        raise FileNotFoundError(f"checkpoint not found: {p} (or {f})")
    obj = torch.load(f, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{f}: expected a state_dict, got {type(obj)}")
    return state_dict_from_reference(obj, model_cfg)
