"""Device mesh and axis conventions (the twin of the JAX package's
``parallel/mesh.py``).

A :class:`Mesh` is a ``(n_data, n_model)`` grid of ``torch.device``s with
the axes

* ``data``  -- the batch dimension (each data coordinate decodes its own rows),
* ``model`` -- tensor parallelism over attention heads and MLP columns.

One host drives every shard (a single controller, as JAX's ``shard_map``
does). A device may appear several times: several shards on one card are the
counterpart of the JAX package's forced host devices, and that is how the
whole meshed decode runs on one GPU. The model ranks of one data coordinate
form a :class:`..ops.tp_allreduce_kernel.TPGroup`, whose K15 all-reduce sums
their row-parallel partials.

JAX's ``data_sharding`` / ``replicated`` describe XLA placements and have no
counterpart: the decode loops place each shard's tensors themselves.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..ops.tp_allreduce_kernel import TPGroup, canonical_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """``devices[d][m]`` is the device of data coordinate d, model rank m;
    ``shape`` maps each axis name to its size, as JAX's ``Mesh.shape``."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices):
        rows = [[canonical_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangle of devices")
        self.devices = rows
        self.shape = {DATA_AXIS: len(rows), MODEL_AXIS: len(rows[0])}
        self._groups: dict[int, TPGroup] = {}

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def tp_group(self, d: int) -> TPGroup:
        """The model ranks of data coordinate ``d`` (kept, so K15's
        exchange buffers are made once per mesh)."""
        g = self._groups.get(d)
        if g is None:
            g = self._groups[d] = TPGroup(self.devices[d])
        return g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh. ``devices`` defaults to every CUDA device (and
    raises without one); pass e.g. ``["cpu"] * 4`` or ``["cuda:0"] * 4`` for
    shards that share a device. ``n_data`` defaults to all devices on the
    data axis; the first ``n_data * n_model`` devices are used, row-major."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * n) for a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} devices, got {len(devices)}")
    return Mesh([devices[i * n_model:(i + 1) * n_model]
                 for i in range(n_data)])


def single_device_mesh(device=None) -> Mesh:
    """A 1 x 1 mesh on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``)."""
    return make_mesh(1, 1, [resolve_device(device)])
