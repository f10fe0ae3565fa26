"""Typed configuration the port needs: the padding ladder, the task and the
model knobs, the encoders' pixel statistics.

Stdlib-only copies of the same names in :mod:`toad_tpu.config`, so that the
port imports nothing of the JAX package. Fields and defaults are the same
(``tests/test_torch_port_boundary.py`` holds them equal), except that
``ModelConfig.use_pallas`` has no counterpart: on CUDA the kernel is the
path.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

# the padding ladder every component defaults to (toad_tpu.config)
DEFAULT_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072, 163840, 262144)

# per-channel pixel statistics the tile encoders normalize with
# (toad_tpu.models.resnet_encoder)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class TaskConfig:
    """A classification task: label dictionaries and column names."""

    name: str
    csv_path: str
    label_dicts: tuple[dict[str, int], ...]
    label_cols: tuple[str, ...] = ("label", "site", "sex")
    patient_strat: bool = False
    patient_voting: str = "max"
    ignore: tuple[str, ...] = ()

    @property
    def n_classes(self) -> tuple[int, ...]:
        return tuple(len(set(d.values())) for d in self.label_dicts)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "TaskConfig":
        raw = json.loads(text)
        known = {f.name for f in dataclasses.fields(TaskConfig)}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise ValueError(f"unknown task-config fields {unknown}; known: {sorted(known)}")
        raw["label_dicts"] = tuple(raw["label_dicts"])
        raw["label_cols"] = tuple(raw.get("label_cols", ("label", "site", "sex")))
        raw["ignore"] = tuple(raw.get("ignore", ()))
        return TaskConfig(**raw)


@dataclass(frozen=True)
class ModelConfig:
    """TOAD MIL architecture knobs (reference ``models/model_toad.py:53-75``)."""

    in_dim: int = 1024
    size_arg: str = "big"  # big: 1024->512, attn 384; small: attn 256
    gate: bool = True
    dropout: bool = False
    dropout_rate: float = 0.25
    n_classes: int = 18
    n_site_classes: int = 2
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # bfloat16 for the tensor-core path

    @property
    def hidden_dim(self) -> int:
        return {"small": 512, "big": 512}[self.size_arg]

    @property
    def attn_dim(self) -> int:
        return {"small": 256, "big": 384}[self.size_arg]
