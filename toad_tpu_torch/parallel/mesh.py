"""Device mesh construction: ('data', 'bag') axes.

PyTorch counterpart of :mod:`toad_tpu.parallel.mesh`. The mesh is a grid of
devices with two axes:

- **data**: bags (slides) are data-parallel, each row of the grid holds a
  slice of the batch dimension;
- **bag**: within a bag, the patch dimension N is cut, each column holds a
  slice of it. Exact because attention pooling is one masked
  softmax-weighted mean over N: each cell's partial statistics combine into
  the whole bag's result (:mod:`.bag_shard`).

The JAX package runs the mesh under GSPMD from one process; so does the
port, with explicit placement: one controller thread puts each cell's slice
of a batch on the cell's device (:mod:`.sharding`), runs each cell's part
of the forward there and brings the small per-cell results to the mesh's
first device (``primary``), where the heads, the loss and the optimizer run.
A device may appear more than once in the grid (``[cuda:0] * 4`` holds a
four-cell mesh on one card, ``[cpu] * 8`` the JAX tests' eight CPU devices);
the work of each cell is the same either way.
"""

from __future__ import annotations

from typing import Sequence

import torch


def mesh_shape_for(n_devices: int, data_shards: int | None = None, bag_shards: int | None = None) -> tuple[int, int]:
    """Resolve a (data, bag) mesh shape for n_devices. Explicit values win;
    otherwise all devices go to the data axis (bags are plentiful)."""
    if data_shards is not None and bag_shards is not None:
        if data_shards * bag_shards != n_devices:
            raise ValueError(f"data_shards*bag_shards = {data_shards*bag_shards} != n_devices = {n_devices}")
        return (data_shards, bag_shards)
    if data_shards is not None:
        if n_devices % data_shards:
            raise ValueError(f"{n_devices} devices not divisible by data_shards={data_shards}")
        return (data_shards, n_devices // data_shards)
    if bag_shards is not None:
        if n_devices % bag_shards:
            raise ValueError(f"{n_devices} devices not divisible by bag_shards={bag_shards}")
        return (n_devices // bag_shards, bag_shards)
    return (n_devices, 1)


def _indexed(d) -> torch.device:
    """``cuda`` without an index is the current card, as tensors moved there
    report it (``cuda:0``), so that a grid device equals its tensors' device."""
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d


def visible_devices() -> list[torch.device]:
    """The cards this process sees, ``cuda:0`` .. ``cuda:{n-1}``; empty where
    CUDA is absent."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


class DeviceMesh:
    """A ``[data][bag]`` grid of devices. ``shape`` maps the axis names to
    their sizes, as ``jax.sharding.Mesh.shape`` does; ``primary`` is the
    grid's first device, where what the cells compute is gathered."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = tuple(tuple(_indexed(d) for d in row) for row in grid)
        if not self.grid or not self.grid[0] or any(len(row) != len(self.grid[0]) for row in self.grid):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {"data": len(self.grid), "bag": len(self.grid[0])}
        self.primary = self.grid[0][0]

    @property
    def size(self) -> int:
        """Cells of the grid (``Mesh.devices.size``)."""
        return self.shape["data"] * self.shape["bag"]

    @property
    def devices(self) -> list[torch.device]:
        """The distinct devices of the grid, in grid order."""
        out: list[torch.device] = []
        for row in self.grid:
            for d in row:
                if d not in out:
                    out.append(d)
        return out

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[[str(d) for d in row] for row in self.grid]})"


def make_mesh(data_shards: int | None = None, bag_shards: int | None = None, devices=None) -> DeviceMesh:
    """A ``(data, bag)`` mesh over ``devices``: the visible cards when None
    (so a mesh runs on the card unless the caller asks for the CPU), or an
    explicit list, which may repeat a device (``[torch.device('cpu')] * 8``)."""
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise RuntimeError("no CUDA device is visible: pass devices= to build a mesh elsewhere "
                               "(for instance [torch.device('cpu')] * n on the CPU)")
    devices = [_indexed(d) for d in devices]
    data_n, bag_n = mesh_shape_for(len(devices), data_shards, bag_shards)
    return DeviceMesh([devices[i * bag_n:(i + 1) * bag_n] for i in range(data_n)])
