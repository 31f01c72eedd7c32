"""A mesh of shards: the port's counterpart of ``jax.sharding.Mesh`` as the
JAX package uses it.

The JAX multi-device layer is single-controller: one process drives every
device of a mesh under ``shard_map``, with explicit collectives.  The port
keeps that design.  A :class:`Mesh` is an array of ``torch.device``, one a
shard, with one array dimension per axis name, and one process launches
every shard's work in shard order.  A device may appear more than once:
four shards on one card run the same exchanges and per-shard launches as
four shards on four cards, one after another, and the collectives of
:mod:`.collectives` copy between them either way.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import default_device

__all__ = ["Mesh", "card_mesh"]


class Mesh:
    """``devices``: an array (nested lists or numpy) of devices, one a
    shard, with ``len(axis_names)`` dimensions (``"cuda"`` is taken as the
    current card).  ``shape[axis]`` is the
    number of shards along ``axis``, as ``jax.sharding.Mesh.shape``."""

    def __init__(self, devices, axis_names):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        nested = np.asarray(devices, dtype=object)
        arr = np.empty(nested.shape, dtype=object)
        for idx, d in np.ndenumerate(nested):
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:  # one name a card
                d = torch.device("cuda", torch.cuda.current_device())
            arr[idx] = d
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"Mesh: devices of shape {arr.shape} for axis names "
                f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: repeated axis name in {axis_names}")
        if arr.size == 0:
            raise ValueError("Mesh: no devices")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def shards(self, axis: str) -> list:
        """The devices of the shards along ``axis``, in order, at index 0 of
        every other axis (where the JAX package replicates, the port
        computes once, on those shards)."""
        if axis not in self.shape:
            raise ValueError(
                f"mesh has no axis {axis!r} (axes {self.axis_names})")
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out

    @property
    def key(self) -> tuple:
        """What identifies the layout (axis names, shape, devices), for
        caches keyed by mesh."""
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def layout(self) -> str:
        """The layout in words, e.g. ``4 shards on 1 card: cuda:0 x4``."""
        counts: dict = {}
        for d in self.devices.flat:
            counts[str(d)] = counts.get(str(d), 0) + 1
        kind = "card" if all(d.type == "cuda" for d in self.devices.flat) \
            else "device"
        where = ", ".join(f"{d} x{c}" for d, c in counts.items())
        return (f"{self.size} shards on {len(counts)} {kind}"
                f"{'s' if len(counts) > 1 else ''}: {where}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.layout()})"


def card_mesh(n_shards, axis_names=("rows",), device=None) -> Mesh:
    """A mesh of ``n_shards`` shards (an int, or a tuple: the mesh shape)
    named ``axis_names``.  By default the shards go round-robin over the
    ``torch.cuda.device_count()`` cards (shard i on card i mod count), so
    one card holds every shard and four cards one each of four.  An
    explicit ``device`` (``"cpu"``, ``"cuda:1"``) holds every shard.  It
    does not probe or fall back: without a card and without ``device`` it
    raises."""
    shape = (n_shards,) if isinstance(n_shards, int) else tuple(n_shards)
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    total = int(np.prod(shape))
    if total < 1:
        raise ValueError(f"card_mesh: {n_shards} shards")
    dev = default_device(device)
    if device is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "card_mesh: no CUDA device; pass device='cpu' for a mesh of "
                "CPU shards")
        flat = [torch.device("cuda", i % count) for i in range(total)]
    else:
        flat = [dev] * total
    arr = np.empty(total, dtype=object)
    arr[:] = flat
    return Mesh(arr.reshape(shape), axis_names)
