"""Production meshes (the port of ``repro.launch.mesh``). A function, not
a module-level constant: importing this module touches no device.

The grids and axis names are the reference's: (16, 16) over ("data",
"model"), or (2, 16, 16) over ("pod", "data", "model") across two pods.
The port's ``Mesh`` is driven by one controller and may repeat a device,
so the 256 (or 512) shards are laid over the CUDA devices present, in
order, each device taking every ``n``-th shard.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.params import resolve_device
from repro_torch.sharding.rules import Mesh, db_shards


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production grid over ``devices`` (a sequence of devices or
    device strings, repeated over the grid in order); None = the CUDA
    devices present (it raises without a card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        resolve_device(None, "make_production_mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("make_production_mesh: no devices given")
    n = int(np.prod(shape))
    grid = np.empty(n, dtype=object)
    for i in range(n):
        grid[i] = devices[i % len(devices)]
    return Mesh(grid.reshape(shape), axes)


# the number of data shards, "pod" x "data" as present: the stable
# store's row shards
data_shards = db_shards
