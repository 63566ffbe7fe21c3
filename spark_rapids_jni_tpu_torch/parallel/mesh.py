"""Device meshes of the PyTorch port.

The port's counterpart of the JAX package's ``parallel/mesh.py``.  The
JAX package is single-controller SPMD: one process drives a
``jax.sharding.Mesh`` of devices and XLA's collectives ride the
interconnect.  The port does the same from one process: a :class:`Mesh`
is a list of torch devices with axis names, the per-shard work of a
collective program is a loop over the shards, the all-to-all exchange is
a copy of each per-destination bucket to its destination's device
(``parallel/shuffle.py``), and a ``psum`` is the sum of the per-shard
partials in shard order.

A mesh may repeat a device: ``Mesh([cuda:0] * 4)`` puts four shards on
one card, where the exchange is a copy on that card and measures no
interconnect.  No ``torch.distributed`` process group is used.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def local_devices(n_devices: int | None = None, device=None) -> list:
    """The first ``n_devices`` cards (all of them when None), or with
    ``device="cpu"`` that many CPU replicas, which share the host.  The
    one source of device handles for the mesh builders here and the
    serving layer's replica placement (``exec/placement.py``), so that an
    index means the same device in both.  Raises when the host has fewer
    cards than asked, or none."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * max(int(n_devices or 1), 1)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on CPU replicas")
    have = torch.cuda.device_count()
    if n_devices is None or n_devices <= 0:
        return [torch.device("cuda", i) for i in range(have)]
    if have < n_devices:
        raise ValueError(f"need {n_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n_devices)]


class Mesh:
    """Devices laid out over named axes: ``devices`` flat, in row-major
    order of ``shape`` (one size an axis of ``axis_names``)."""

    def __init__(self, devices: Sequence, axis_names=("data",),
                 shape: Sequence[int] | None = None):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = ((axis_names,) if isinstance(axis_names, str)
                           else tuple(axis_names))
        self.shape_tuple = (tuple(shape) if shape is not None
                            else (len(self.devices),))
        if len(self.shape_tuple) != len(self.axis_names):
            raise ValueError("one size per axis name")
        if math.prod(self.shape_tuple) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"{self.shape_tuple} mesh")

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.shape_tuple))

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis_name) -> int:
        """The shard count over ``axis_name`` (a name or a tuple of
        names)."""
        axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
        return math.prod(self.shape[a] for a in axes)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axes={self.shape})")


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` cards, or ``n_devices`` CPU
    replicas with ``device="cpu"`` (the executor-pool analog)."""
    return Mesh(local_devices(n_devices, device), (axis_name,))


def make_2d_mesh(n_hosts: int, chips_per_host: int,
                 host_axis: str = "dcn", chip_axis: str = "ici",
                 device=None) -> Mesh:
    """2-D mesh (hosts × chips) with the slow axis outermost, as the JAX
    package's."""
    devs = local_devices(n_hosts * chips_per_host, device)
    return Mesh(devs, (host_axis, chip_axis), (n_hosts, chips_per_host))
