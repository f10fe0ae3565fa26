"""Batch layouts over the ('data', 'bag') mesh, and per-device weights.

PyTorch counterpart of :mod:`toad_tpu.parallel.sharding`. The weights are
replicated (the model is ~1.2M parameters: a copy on each device keeps every
product local); a batch is cut bag dimension over ``data`` and patch
dimension over ``bag``. Where the JAX package hands GSPMD a layout and lets
it place the pieces, :func:`shard_batch` places them: each cell of the grid
gets its slice of the batch on its own device.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from toad_tpu_torch.parallel.mesh import DeviceMesh

# the mesh axes each key of a batch is cut over, in the order of its
# dimensions (the JAX package's batch_shardings as PartitionSpecs); the int8
# wire's row scales follow the patch mask
BATCH_AXES = {
    "features": ("data", "bag", None),
    "patch_mask": ("data", "bag"),
    "scales": ("data", "bag"),
    "bag_mask": ("data",),
    "label": ("data",),
    "site": ("data",),
    "sex": ("data",),
}

# the keys that stay whole on the mesh's primary device: all but the rows,
# which are the only large planes (the heads, the loss and A_raw's mask read them)
WHOLE_KEYS = ("patch_mask", "bag_mask", "label", "site", "sex")


class ShardedBatch(dict):
    """A batch placed over a mesh. As a mapping it holds :data:`WHOLE_KEYS`
    for the whole batch on ``mesh.primary`` (what the loss and the heads
    read); ``cells[d][b]`` is the dict of grid cell (d, b)'s slice of every
    key, on that cell's device."""

    def __init__(self, mesh: DeviceMesh, cells: list[list[dict[str, torch.Tensor]]], whole: Mapping[str, torch.Tensor]):
        super().__init__(whole)
        self.mesh = mesh
        self.cells = cells

    def replace(self, **whole: torch.Tensor) -> "ShardedBatch":
        """The same cells with some whole-batch keys replaced."""
        return ShardedBatch(self.mesh, self.cells, {**self, **whole})


def _tensor(v: Any) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def shard_batch(batch: Mapping[str, Any], mesh: DeviceMesh) -> ShardedBatch:
    """Place a batch (host arrays or tensors) over the mesh. Requires B %
    data and N % bag divisibility."""
    b, n = batch["features"].shape[:2]
    data_n, bag_n = mesh.shape["data"], mesh.shape["bag"]
    if b % data_n:
        raise ValueError(f"batch size {b} not divisible by data axis {data_n}")
    if n % bag_n:
        raise ValueError(f"bucket size {n} not divisible by bag axis {bag_n}")
    per_b, per_n = b // data_n, n // bag_n
    tensors = {k: _tensor(v) for k, v in batch.items()}
    cells = []
    for d, row in enumerate(mesh.grid):
        rows = slice(d * per_b, (d + 1) * per_b)
        cells.append([
            {k: (v[rows, j * per_n:(j + 1) * per_n] if len(BATCH_AXES.get(k, ())) > 1 else v[rows]).to(dev, non_blocking=True)
             for k, v in tensors.items()}
            for j, dev in enumerate(row)
        ])
    return ShardedBatch(mesh, cells, {k: tensors[k].to(mesh.primary) for k in WHOLE_KEYS if k in tensors})


def copy_to(model: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """An eval-mode copy of ``model``'s weights on ``dev``: a new model of its
    config holding its state_dict. Made outside inference mode even when
    called inside it (an eval pass makes its copies there), so that its
    weights are ordinary tensors whose version counters the kernel-operand
    caches read."""
    with torch.inference_mode(False), torch.no_grad():
        copy = type(model)(model.config)
        copy.load_state_dict(model.state_dict())
        return copy.to(dev).eval().requires_grad_(False)


def replicate(mesh: DeviceMesh, model: torch.nn.Module) -> dict[torch.device, torch.nn.Module]:
    """One eval-mode copy of ``model``'s weights on each distinct device of
    the mesh: ``model`` itself on the device it lives on, :func:`copy_to`
    elsewhere."""
    home = next(model.parameters()).device
    return {dev: model if dev == home else copy_to(model, dev) for dev in mesh.devices}
