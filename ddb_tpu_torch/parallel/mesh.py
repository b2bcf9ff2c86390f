"""Device mesh helpers (PyTorch port of ddb_tpu/parallel/mesh.py).

One mesh axis ("d") spans the shards; tables are hash-partitioned over
it.  A two-level mesh ("h", "d") names hosts and the chips of a host for
the hierarchical exchange.

The reference's mesh is a `jax.sharding.Mesh`, whose devices are
distinct.  Here a mesh is a tuple of torch devices in which a device may
repeat (a deviation of structure): `Mesh([torch.device("cuda", 0)] * 4)`
is four shards on one card, and `Mesh([torch.device("cpu")] * 8)` is the
counterpart of the reference's eight virtual CPU devices.  A sharded
array is a list with one tensor per shard; shard i of an array of `cap`
rows holds rows [i*cap/n, (i+1)*cap/n), the layout of `P("d")`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

AXIS = "d"


class Mesh:
    """Shards laid out along named axes.  `devices` is flat, in row-major
    order of `shape` (for ("h", "d"): host-major)."""

    def __init__(self, devices, axis_names: Sequence[str] = (AXIS,)):
        axis_names = tuple(axis_names)
        if len(axis_names) == 1:
            flat = [torch.device(d) for d in devices]
            sizes = [len(flat)]
        elif len(axis_names) == 2:
            rows = [list(r) for r in devices]
            if len({len(r) for r in rows}) != 1:
                raise ValueError("a 2-D mesh needs rows of one length")
            flat = [torch.device(d) for r in rows for d in r]
            sizes = [len(rows), len(rows[0])]
        else:
            raise ValueError("a mesh has one or two axes")
        if not flat:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(flat)
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over `devices`, by default every visible CUDA device;
    `n_devices` keeps the first n."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (for example [cpu] * 8)")
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (AXIS,))


def row_sharding(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Split `t` (rows a multiple of the mesh size) into the mesh's row
    shards, each on its shard's device (a view where it already lies
    there)."""
    n = mesh.size
    per = t.shape[0] // n
    if per * n != t.shape[0]:
        raise ValueError(f"{t.shape[0]} rows do not split into {n} shards")
    return [t[i * per:(i + 1) * per].to(dev, non_blocking=True)
            for i, dev in enumerate(mesh.devices)]
