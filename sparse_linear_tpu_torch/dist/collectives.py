"""The three collectives the JAX multi-device layer uses, on per-shard
tensors: the counterparts of ``jax.lax.ppermute``, ``jax.lax.all_gather``
(``tiled=True``) and ``jax.lax.psum`` inside ``shard_map``.

A collective takes a list of tensors in shard order, one on each shard's
device, and returns new ones in shard order.  Every result is a fresh
tensor on its destination's device, also when source and destination share
a device: ``Tensor.to(same_device)`` returns the tensor itself, and a halo
piece that aliased its neighbour's shard would be changed under it by the
in-place updates of an iteration (CG's ``addcmul_``).

Ordering across cards.  The kernels launch on
``torch.cuda.current_stream(device)`` (``kernels/spmv_dia.py``), and every
copy here is PyTorch's device-to-device ``Tensor.to`` (ATen's
``copy_device_to_device``): the copy runs on the source's current stream,
after the work already queued there (the kernel that wrote the piece),
behind an event recorded on the destination's current stream (so it does
not overwrite memory the destination still reads), and the destination's
current stream waits for the copy before any later launch there.  So a
piece moves between a kernel that writes it and one that reads it with no
host synchronisation.  One card cannot show this ordering (every shard
shares one stream there); it holds by construction.

``gather`` and ``psum`` are the spans ``slt.dist.gather`` and
``slt.dist.psum`` (args: the destination device) in a trace.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.utils.profiling import annotate

__all__ = ["fresh", "ppermute", "all_gather", "gather", "psum"]


def fresh(t: torch.Tensor, device) -> torch.Tensor:
    """A new tensor on ``device`` holding ``t``'s values (never ``t``
    itself)."""
    return t.to(torch.device(device), copy=True)


def ppermute(pieces, perm) -> list:
    """``jax.lax.ppermute``: shard ``dst`` receives ``pieces[src]`` for each
    ``(src, dst)`` in ``perm``, on its own piece's device; a shard that
    receives nothing gets zeros shaped like its own piece."""
    out: list = [None] * len(pieces)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"ppermute: shard {dst} receives twice")
        out[dst] = fresh(pieces[src], pieces[dst].device)
    return [torch.zeros_like(p) if o is None else o
            for o, p in zip(out, pieces)]


def gather(pieces, device, dim: int = 0) -> torch.Tensor:
    """The pieces concatenated along ``dim`` in shard order on one
    ``device`` (the tiled all-gather as one shard sees it)."""
    device = torch.device(device)
    with annotate("slt.dist.gather", device):
        if len(pieces) == 1:
            return fresh(pieces[0], device)
        return torch.cat([p.to(device) for p in pieces], dim=dim)


def all_gather(pieces) -> list:
    """``jax.lax.all_gather(..., tiled=True)``: every shard receives the
    concatenation of all pieces in shard order, on its own piece's
    device."""
    return [gather(pieces, p.device) for p in pieces]


def psum(values, device) -> torch.Tensor:
    """``jax.lax.psum`` onto one ``device``: the values summed in shard
    order, ``((v0 + v1) + v2) + ...``, so that the result does not depend
    on which shard finished first."""
    device = torch.device(device)
    with annotate("slt.dist.psum", device):
        if len(values) == 1:
            return fresh(values[0], device)
        total = values[0].to(device) + values[1].to(device)
        for v in values[2:]:
            total += v.to(device)
        return total
