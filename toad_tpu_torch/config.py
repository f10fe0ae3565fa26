"""Typed configuration the port needs: the padding ladder, the task, model,
ResNet-50 encoder, optimizer, data, training and split knobs, the encoders'
pixel statistics.

Stdlib-only copies of the same names in :mod:`toad_tpu.config`, so that the
port imports nothing of the JAX package. Fields and defaults are the same
(``tests/test_torch_port_boundary.py`` holds them equal), except the fields
with nothing behind them here: ``ModelConfig.use_pallas`` (on CUDA the
kernel is the path), ``DataConfig.native`` (no native loader),
``TrainConfig.rss_restart_gb``, ``profile_dir``, ``debug_checks``,
``data_shards`` and ``bag_shards`` (ROADMAP.md: profiling and debugging
tools, multi-GPU).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

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


@dataclass(frozen=True)
class EncoderConfig:
    """Truncated ResNet-50 patch encoder (reference ``models/resnet_custom.py``:
    stem + layers 1-3, no layer4/fc, GAP -> 1024-d; ``:62-70,96-109``)."""

    blocks: tuple[int, ...] = (3, 4, 6)  # bottleneck counts per stage (truncated)
    stem_width: int = 64
    expansion: int = 4
    bn_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    fold_bn: bool = True  # fold inference BN into conv weights
    # the 7x7/2 stem conv as space-to-depth(2) + a 4x4/1 conv: the same
    # arithmetic on 12 input channels instead of 3
    stem_s2d: bool = True

    @property
    def stage_widths(self) -> tuple[int, ...]:
        return tuple(self.stem_width * (2**i) for i in range(len(self.blocks)))

    @property
    def out_dim(self) -> int:
        return self.stage_widths[-1] * self.expansion  # 256*4 = 1024 truncated


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer knobs with torch semantics (reference ``utils/utils.py:63-70``)."""

    name: str = "adam"  # adam | sgd
    lr: float = 1e-4
    weight_decay: float = 1e-5  # torch-style L2-in-gradient, NOT decoupled
    momentum: float = 0.9  # sgd only
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclass(frozen=True)
class DataConfig:
    """Bag loading + bucketed batching.

    ``batch_size=1`` with ``bucket_sizes=None`` reproduces the reference's
    bag-at-a-time semantics (``utils/utils.py:37-61``); larger batches with
    bucketed padding are the throughput mode.
    """

    data_dir: str | dict[str, str] | None = None
    batch_size: int = 1
    bucket_sizes: tuple[int, ...] = DEFAULT_BUCKETS
    max_bag_size: int | None = None  # truncate bags longer than this
    use_h5: bool = False
    prefetch: int = 2
    weighted_sample: bool = False
    testing_frac: float | None = None  # reference --testing: 1% subsample
    patient_bags: bool = False  # concat all of a patient's slides into one bag
    # host->device feature dtype: 'bfloat16' halves the bytes copied; 'auto'
    # picks bfloat16 iff the model computes in bf16 (the features are cast
    # round-to-nearest-even either side of the copy, so casting on the host
    # is numerically invisible there); 'float32' is exact
    transfer_dtype: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    """One experiment (k folds). Defaults mirror ``main_mtl_concat.py:83-106``."""

    exp_code: str = "exp"
    task: str = "dummy_mtl_concat"
    results_dir: str = "./results"
    split_dir: str | None = None
    max_epochs: int = 200
    seed: int = 1
    k: int = 10
    k_start: int = -1
    k_end: int = -1
    early_stopping: bool = False
    patience: int = 20
    min_stop_epoch: int = 50
    cls_loss_weight: float = 0.75
    site_loss_weight: float = 0.25
    log_data: bool = False
    testing: bool = False
    # preemption tolerance: snapshot the full training state (model, optimizer,
    # generator and early-stop state) every `resume_every` epochs and continue
    # from it on restart, a capability the reference lacks
    resume: bool = False
    resume_every: int = 1
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def settings_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["num_splits"] = self.k
        return d


@dataclass(frozen=True)
class SplitConfig:
    """Split creation. Defaults mirror ``create_splits.py:9-18,43-45``."""

    task: str = "dummy_mtl_concat"
    seed: int = 1
    k: int = 10
    label_frac: float = 1.0
    val_frac: float = 0.1
    test_frac: float = 0.2
    hold_out_test: bool = False
    split_code: str | None = None
    split_root: str = "splits"


def fold_range(k: int, k_start: int, k_end: int) -> range:
    """Resolve the [k_start, k_end) fold window (reference ``main_mtl_concat.py:28-35``)."""
    start = 0 if k_start == -1 else k_start
    end = k if k_end == -1 else k_end
    return range(start, end)
