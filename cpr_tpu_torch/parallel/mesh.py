"""A mesh of shards: the port's stand-in for `jax.sharding.Mesh`.

Reference counterpart: the `jax.sharding.Mesh` that `cpr_tpu/parallel/`
builds (`default_mesh`, `cpr_tpu/parallel/__init__.py:81-85`). A `Mesh`
is an n-D array of `torch.device` with one name an axis; `mesh.shape`
maps each name to its size, as jax's does, so `mesh.shape[axis]` is the
shard count on `axis`.

A device may repeat: a mesh of four shards on `cuda:0` is how one card
runs the sharded paths, as the reference's tests run them on eight
virtual CPU devices. Everything runs in one process. Shards on one
device share its buffers (a replicated vector is one tensor, each shard
writes its slice in place); a device of its own gets the slices of the
others by peer copies, which PyTorch orders on both devices' current
streams (`exchange_slices`). No NCCL, no `torch.distributed`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "default_mesh", "exchange_slices"]


def _indexed(d: torch.device) -> torch.device:
    """`cuda` as the current card's `cuda:i`, so shards named either way
    share one card's buffers."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-D array of devices with named axes."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"{arr.ndim}-D devices for axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis name in {names}")
        flat = [_indexed(torch.device(d)) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for k in range(self.devices.shape[i]):
            idx[i] = k
            out.append(self.devices[tuple(idx)])
        return out

    def grid_devices(self, axis: str, state_axis: str) -> np.ndarray:
        """The [n_axis, n_state_axis] devices of a 2-D mesh."""
        if self.devices.ndim != 2 or {axis, state_axis} != set(
                self.axis_names):
            raise ValueError(
                f"a 2-D mesh with axes ({axis!r}, {state_axis!r}) is "
                f"needed, got axes {self.axis_names}")
        d = self.devices
        return d if self.axis_names[0] == axis else d.T


def default_mesh(axis: str = "d", devices=None) -> Mesh:
    """One-dimensional mesh over the given devices, or every visible CUDA
    device. The tests pass `devices=["cpu"] * n`."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "cpr_tpu_torch runs on a CUDA device and none is available; "
                "pass devices=['cpu'] * n to shard on the host")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(np.asarray([torch.device(d) for d in devices], dtype=object),
                (axis,))


def distinct(devices) -> list[torch.device]:
    """The devices of a shard list, each once, in first-seen order."""
    out: list[torch.device] = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def exchange_slices(replicas: dict, slices) -> None:
    """Bring every device's replica of a set of buffers up to date.

    `replicas` maps a device to its list of replicated tensors (same
    shapes on every device); `slices` lists (device, index) pairs: the
    part `index` of each buffer that the shards on `device` wrote. Each
    part is copied to the replicas of the other devices. With one device
    there is nothing to do (its shards wrote into the shared buffers)."""
    if len(replicas) < 2:
        return
    for dev, index in slices:
        src = replicas[dev]
        for other, dst in replicas.items():
            if other == dev:
                continue
            for s, d in zip(src, dst):
                d[index].copy_(s[index], non_blocking=True)
