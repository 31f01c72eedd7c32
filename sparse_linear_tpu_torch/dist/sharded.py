"""Sharded data on a :class:`.mesh.Mesh`: the port's counterparts of the
JAX package's arrays under ``NamedSharding(mesh, P(axis))``.

* :class:`ShardedVector` holds one tensor a shard along one mesh axis, in
  shard order, each on its shard's device, and the global length.  It is
  what ``dist.spmv.spmv_sharded`` and ``dia_spmv_sharded`` return where
  the JAX functions return a row-sharded array.  Shard ``d``'s piece holds
  the rows of its slab; rows past the global length (the padding of the
  last slabs) are zero and stay zero under the vector operations.  It
  carries the shard-wise updates a CG step needs (``add_``, ``addcmul_``,
  ``mul_``, ``-``) and answers ``torch.dot`` / ``torch.vdot`` /
  ``torch.linalg.vector_norm`` / ``torch.zeros_like`` through
  ``__torch_function__``, so ``solve.cg.cg`` runs on it unchanged: each
  reduction is a per-shard reduction and a psum onto the first shard's
  device, in shard order.
* :class:`ShardedDIA` is a DIA operator row-sharded over the mesh: each
  shard's slab of ``data``, and the two local operators the exchanges run
  kernel A on, built once on the shard's device.
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_linear_tpu_torch.dist.collectives import gather, psum
from sparse_linear_tpu_torch.formats.structured import DIA

__all__ = ["ShardedVector", "ShardedDIA", "split"]


def split(x: torch.Tensor, devices, block: int) -> list:
    """``x`` cut into ``len(devices)`` pieces of ``block`` entries (the last
    zero-padded), each a fresh tensor on its shard's device."""
    n = x.shape[0]
    total = block * len(devices)
    if n > total:
        raise ValueError(f"split: {n} entries exceed {len(devices)} x {block}")
    pieces = []
    for d, dev in enumerate(devices):
        lo, hi = min(d * block, n), min((d + 1) * block, n)
        p = torch.zeros((block,), dtype=x.dtype, device=dev)
        p[:hi - lo] = x[lo:hi]
        pieces.append(p)
    return pieces


def _piece(v, i, device):
    """Shard i's operand: its piece of a ShardedVector, a 0-d tensor on its
    device, or a Python scalar as one."""
    if isinstance(v, ShardedVector):
        return v.pieces[i]
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(v, device=device)


class ShardedVector:
    """A vector row-sharded over ``mesh[axis]``; see the module docstring.
    ``pieces[d]`` lies on shard d's device; ``length`` is the global
    length (at most the pieces' total)."""

    def __init__(self, mesh, axis: str, pieces, length: int):
        pieces = list(pieces)
        if len(pieces) != mesh.shape[axis]:
            raise ValueError(
                f"ShardedVector: {len(pieces)} pieces for "
                f"{mesh.shape[axis]} shards along {axis!r}")
        if length > sum(p.shape[0] for p in pieces):
            raise ValueError("ShardedVector: length exceeds the pieces")
        self.mesh, self.axis, self.pieces = mesh, axis, pieces
        self.length = int(length)

    @classmethod
    def from_tensor(cls, x, mesh, axis: str = "rows", block=None):
        """``x`` split over ``mesh[axis]`` in blocks of ``block`` entries
        (by default ceil(len / shards)), each piece fresh on its shard."""
        ndev = mesh.shape[axis]
        block = -(-x.shape[0] // ndev) if block is None else int(block)
        return cls(mesh, axis, split(x, mesh.shards(axis), block),
                   x.shape[0])

    # -- layout ------------------------------------------------------------

    @property
    def devices(self) -> list:
        return [p.device for p in self.pieces]

    @property
    def device(self) -> torch.device:
        """The first shard's device: where reductions land."""
        return self.pieces[0].device

    @property
    def blocks(self) -> tuple:
        return tuple(int(p.shape[0]) for p in self.pieces)

    @property
    def dtype(self):
        return self.pieces[0].dtype

    def is_complex(self) -> bool:
        return self.dtype.is_complex

    def full(self, device=None) -> torch.Tensor:
        """The whole vector gathered on ``device`` (by default the first
        shard's)."""
        return gather(self.pieces, self.device if device is None
                      else device)[:self.length]

    def _like(self, pieces) -> "ShardedVector":
        return ShardedVector(self.mesh, self.axis, pieces, self.length)

    def _check(self, other) -> None:
        if isinstance(other, ShardedVector) and (
                other.blocks != self.blocks or other.length != self.length
                or other.devices != self.devices):
            raise ValueError(
                f"ShardedVector: layouts differ ({self.length} in "
                f"{self.blocks} on {self.devices} vs {other.length} in "
                f"{other.blocks} on {other.devices})")

    # -- shard-wise arithmetic ---------------------------------------------

    def clone(self) -> "ShardedVector":
        return self._like([p.clone() for p in self.pieces])

    def zeros_like(self) -> "ShardedVector":
        return self._like([torch.zeros_like(p) for p in self.pieces])

    def _binary(self, other, op) -> "ShardedVector":
        self._check(other)
        return self._like([op(p, _piece(other, i, p.device))
                           for i, p in enumerate(self.pieces)])

    def __add__(self, other):
        return self._binary(other, torch.add)

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    __rmul__ = __mul__

    def add_(self, other, alpha=1) -> "ShardedVector":
        self._check(other)
        for i, p in enumerate(self.pieces):
            p.add_(_piece(other, i, p.device), alpha=alpha)
        return self

    def addcmul_(self, t1, t2, value=1) -> "ShardedVector":
        self._check(t1)
        self._check(t2)
        for i, p in enumerate(self.pieces):
            p.addcmul_(_piece(t1, i, p.device), _piece(t2, i, p.device),
                       value=value)
        return self

    def mul_(self, other) -> "ShardedVector":
        self._check(other)
        for i, p in enumerate(self.pieces):
            p.mul_(_piece(other, i, p.device))
        return self

    # -- reductions: per shard, then a psum in shard order -----------------

    def vdot(self, other) -> torch.Tensor:
        """sum conj(self) * other, as ``torch.vdot`` (a 0-d tensor on the
        first shard's device)."""
        self._check(other)
        return psum([torch.vdot(p, q)
                     for p, q in zip(self.pieces, other.pieces)], self.device)

    def dot(self, other) -> torch.Tensor:
        self._check(other)
        return psum([torch.dot(p, q)
                     for p, q in zip(self.pieces, other.pieces)], self.device)

    def norm(self) -> torch.Tensor:
        """The 2-norm (a 0-d real tensor on the first shard's device)."""
        return torch.sqrt(psum(
            [torch.linalg.vector_norm(p) ** 2 for p in self.pieces],
            self.device))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.dot, torch.vdot) and not kwargs:
            a, b = args
            return a.dot(b) if func is torch.dot else a.vdot(b)
        if func is torch.zeros_like and not kwargs:
            return args[0].zeros_like()
        if func is torch.linalg.vector_norm and len(args) == 1 and all(
                kwargs.get(k, d) == d for k, d in (("ord", 2), ("dim", None))):
            return args[0].norm()
        return NotImplemented

    def __repr__(self) -> str:
        return (f"ShardedVector(length={self.length}, blocks={self.blocks}, "
                f"dtype={self.dtype}, devices={self.devices})")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedDIA:
    """A DIA operator row-sharded over ``mesh[axis]``: ``data[d]`` is shard
    d's (ndiag, nrows / shards) slab, contiguous on its device.  The two
    local operators of each slab share that slab:

    * ``halo_slabs[d]``: shape (n_local, n_local + 2 halo), offsets
      ``off + halo``, over the halo-extended x (None when the band is wider
      than a slab or the matrix is not square);
    * ``gather_slabs[d]``: shape (n_local, ncols), offsets ``off + r0``
      with r0 = d n_local, over the all-gathered x.

    Their ``offsets_tensor`` is made here, once, so that no SpMV copies
    offsets to the card."""

    data: list
    shape: tuple
    offsets: tuple
    axis: str
    mesh: object
    halo: int
    halo_slabs: list | None
    gather_slabs: list

    def full(self, device=None) -> DIA:
        """The unsharded DIA, gathered on ``device`` (by default the first
        shard's)."""
        device = self.data[0].device if device is None else device
        return DIA(data=torch.cat([d.to(device) for d in self.data], dim=1),
                   shape=self.shape, offsets=self.offsets)
