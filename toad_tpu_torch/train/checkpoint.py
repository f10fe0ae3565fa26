"""Checkpointing for the port: loading a reference-layout checkpoint, and
atomic snapshots of the training state.

Counterpart of :mod:`toad_tpu.train.checkpoint`. The best checkpoint of a
fold is ``s_{fold}_checkpoint.pt`` in the reference layout (a bare
state_dict, as the reference writes it and as ``python -m toad_tpu export``
converts an Orbax checkpoint), which :func:`load_params_any` and ``serve
--ckpt`` read. A resume snapshot is one ``torch.save``d dict (model and
optimizer state_dicts, the generator's state, epoch, early-stop state).
Every save goes to a temp name beside the target and is swapped in with
``os.replace``, so a save that fails or is killed at any point leaves the
previous snapshot in place. Orbax directories need the JAX stack and are
not read here.
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path
from typing import Any

import torch

from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.models.interop import state_dict_from_reference


def checkpoint_name(fold: int) -> str:
    return f"s_{fold}_checkpoint.pt"


def save_checkpoint(path: str | os.PathLike, state: Any) -> None:
    """Atomically save ``state`` (tensors, numbers, strings, and dicts and
    lists of them) to the file ``path``."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    for stale in path.parent.glob(f".tmp_{path.name}.*"):  # left by killed saves
        stale.unlink()
    tmp = path.parent / f".tmp_{path.name}.{uuid.uuid4().hex[:8]}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def recover_checkpoint(path: str | os.PathLike) -> Path | None:
    """``path`` if a snapshot is there, else None. The swap in
    :func:`save_checkpoint` is one rename, so there is no half-written state
    to repair."""
    path = Path(path).absolute()
    return path if path.exists() else None


def restore_checkpoint(path: str | os.PathLike) -> Any:
    """What :func:`save_checkpoint` saved, on the CPU."""
    return torch.load(Path(path).absolute(), map_location="cpu", weights_only=True)


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
