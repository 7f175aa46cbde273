"""Device mesh and axis conventions (the twin of the JAX package's
``parallel/mesh.py``).

A :class:`Mesh` is a ``(n_data, n_model)`` grid of ``torch.device``s with
the axes

* ``data``  -- the batch dimension (each data coordinate decodes its own rows),
* ``model`` -- tensor parallelism over attention heads and MLP columns.

One host drives every shard (a single controller, as JAX's ``shard_map``
does). A device may appear several times: several shards on one card are the
counterpart of the JAX package's forced host devices, and that is how the
whole meshed decode and the meshed training steps run on one GPU. The model
ranks of one data coordinate form a
:class:`..ops.tp_allreduce_kernel.TPGroup` (:meth:`Mesh.tp_group`), whose
K15 all-reduce sums their row-parallel partials; the data shards of model
rank 0 form another (:meth:`Mesh.dp_group`), whose K15 sums the data
shards' gradients and loss sums in training (``parallel/trainer``).

:func:`data_sharding` and :func:`replicated` are the placements the training
builders use: a batch cut over the data shards, a tree copied to each
distinct device. :func:`train_devices` is the trainers' one seam that lists
the devices they may train on, and :func:`train_mesh` the data-parallel mesh
they take over them.
"""

from __future__ import annotations

import contextlib

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
        self._dp_group: TPGroup | None = None

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

    def dp_group(self) -> TPGroup:
        """The data shards of model rank 0: the group whose K15 sums the
        data shards' gradients (kept, as :meth:`tp_group`). K15 takes 2 or
        4 ranks: another data-axis size (but 1, which needs no sum) raises
        ValueError, where JAX's ``psum`` takes any."""
        n = self.shape[DATA_AXIS]
        if n not in (2, 4):
            raise ValueError(f"a data axis of {n} shards: the gradient sum "
                             f"(K15) takes 2 or 4")
        if self._dp_group is None:
            self._dp_group = TPGroup([row[0] for row in self.devices])
        return self._dp_group

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


def on_device(dev: torch.device):
    """The guard for a shard's work on ``dev``: the port's kernels launch on
    the current CUDA device's stream, so a shard on another card makes its
    card current (autograd's backward does so itself); nothing on the
    CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def data_sharding(mesh: Mesh, batch: dict) -> list[dict]:
    """``batch`` cut over the data axis, one dict per data shard: each
    tensor leaf's dim 0 into ``n_data`` equal contiguous parts, part d on
    data shard d's device (its model rank 0); a 0-d tensor goes whole to
    every shard's device and anything else (a float of the batch such as
    ``tf_prob``) to every shard as it is (JAX's ``P(data)`` / ``P()`` of
    ``_batch_specs``)."""
    n = mesh.shape[DATA_AXIS]
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        if not torch.is_tensor(v):
            for shard in out:
                shard[k] = v
            continue
        if v.dim() == 0:
            parts = [v] * n
        elif v.shape[0] % n:
            raise ValueError(f"batch leaf {k!r} of {v.shape[0]} rows does "
                             f"not split over {n} data shards")
        else:
            parts = v.chunk(n)
        for d, shard in enumerate(out):
            shard[k] = parts[d].to(mesh.devices[d][0])
    return out


def replicated(mesh: Mesh, tree: dict) -> list[dict]:
    """``tree`` on each data shard's device, one tree per data shard: one
    copy per distinct device, shared by the shards that lie on it (on one
    card, the tree itself)."""
    def place(t, dev):
        if isinstance(t, dict):
            return {k: place(v, dev) for k, v in t.items()}
        return t.to(dev) if torch.is_tensor(t) else t

    copies = {}
    for row in mesh.devices:
        if row[0] not in copies:
            copies[row[0]] = place(tree, row[0])
    return [copies[row[0]] for row in mesh.devices]


def train_devices(device=None) -> list[torch.device]:
    """The devices a trainer may train on: every CUDA device for ``cuda``
    without an index (the default), else ``device`` alone; the first is the
    one a trainer keeps its state on."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def train_mesh(devices: list, batch_size: int) -> Mesh | None:
    """The trainers' data-parallel mesh over ``devices``: the first 4, else
    the first 2, where there are that many and the batch divides by their
    count (K15 sums 2 or 4 data shards, where JAX shards over every device
    whose count divides the batch); None (one device) otherwise."""
    for n in (4, 2):
        if len(devices) >= n and batch_size % n == 0:
            return make_mesh(n, 1, devices[:n])
    return None
