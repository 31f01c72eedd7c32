"""CG's vector work on the card: wrappers around ``csrc/cg_step.cu``.

One unpreconditioned CG iteration after the caller's product q = A p is
three passes, each a hand-written kernel on CUDA tensors:

* :func:`cg_pq`: alpha = gamma / Re(p^H q);
* :func:`cg_update`: x += alpha p, r -= alpha q, and in the same pass
  g = Re(r^H r); then beta = g / gamma, gamma = g, one more iteration
  counted, and the stop flag set once g is not above the target;
* :func:`cg_direction`: p = r + beta p.

They replace no TPU kernel (the JAX package's CG is a ``lax.while_loop``
that XLA fuses); they exist so that a solve moves fewer bytes and the host
need not read a scalar every iteration.  The scalars live in a float64
*state* tensor on the vectors' device, made by :func:`cg_state`, which
also holds the scratch of the kernels' reductions (one partial sum a
block): its slots are named below.  Every kernel does nothing once the
stop flag is set, so x, r and p end bitwise at the iteration that set it,
however many iterations were queued after it.  The reductions run in a
fixed order (no floating-point atomics): two runs give bitwise the same
numbers.

Each wrapper takes its plain PyTorch version (:func:`cg_pq_plain`, ...)
only because its tensors lie on the CPU; on CUDA tensors it launches its
kernel on the current stream or raises.  The plain versions repeat the
port's earlier per-iteration loop operation for operation (``addcmul_``,
``torch.dot`` / ``torch.vdot``, ``mul_``, ``add_``), so on the CPU a solve
is bitwise that loop.  Each wrapper counts its launches in ``.launches``
(a plain int; set it to 0 to reset).
"""

from __future__ import annotations

import functools

import torch

from sparse_linear_tpu_torch.dtypes import real_of
from sparse_linear_tpu_torch.kernels import _build

__all__ = ["GAMMA", "ALPHA", "BETA", "TARGET", "STOP", "ITER", "GAMMA0",
           "SLOTS", "inner", "cg_state", "cg_pq", "cg_update", "cg_direction",
           "cg_pq_plain", "cg_update_plain", "cg_direction_plain"]

# slots of the state tensor (csrc/cg_step.cu names the same); slot 7 is the
# kernels' reduction ticket, then one partial sum a block
GAMMA, ALPHA, BETA, TARGET, STOP, ITER, GAMMA0 = range(7)
SLOTS = 8

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128"}
_THREADS = 256
_BLOCKS_PER_SM = 8  # 2,048 threads an SM


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(n: int, device: torch.device) -> int:
    """Blocks of the kernels' grid for vectors of ``n``: enough to fill
    the card, fewer for a short vector, at least one."""
    if device.type != "cuda":
        return 1
    return max(1, min(-(-n // _THREADS), _sms(device.index) * _BLOCKS_PER_SM))


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re(a^H b) as a 0-d tensor on the device."""
    if a.is_complex():
        return torch.vdot(a, b).real
    return torch.dot(a, b)


def cg_state(r: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The state of a solve whose first residual is ``r``: gamma = gamma0 =
    Re(r^H r), the stop target (a float64 0-d tensor, (tol ||b||)^2), the
    stop flag already set where gamma is not above it, and room for the
    kernels' partial sums.  Nothing is read on the host."""
    gamma = inner(r, r).to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=r.device)
    stop = (~(gamma > target)).to(torch.float64)
    state = torch.zeros(SLOTS + _blocks(r.numel(), r.device),
                        dtype=torch.float64, device=r.device)
    state[:GAMMA0 + 1] = torch.stack(
        [gamma, zero, zero, target.to(torch.float64), stop, zero, gamma])
    return state


def cg_pq_plain(p, q, state) -> None:
    """:func:`cg_pq` in plain PyTorch."""
    if state[STOP]:
        return
    state[ALPHA] = state[GAMMA].to(real_of(p.dtype)) / inner(p, q)


def cg_update_plain(x, r, p, q, state) -> None:
    """:func:`cg_update` in plain PyTorch."""
    if state[STOP]:
        return
    real = real_of(x.dtype)
    alpha = state[ALPHA].to(real)
    x.addcmul_(alpha, p)
    r.addcmul_(alpha, q, value=-1)
    g = inner(r, r)
    state[BETA] = g / state[GAMMA].to(real)
    state[GAMMA] = g
    state[ITER] += 1
    if not g > state[TARGET]:
        state[STOP] = 1


def cg_direction_plain(p, r, state) -> None:
    """:func:`cg_direction` in plain PyTorch."""
    if state[STOP]:
        return
    p.mul_(state[BETA].to(real_of(p.dtype))).add_(r)


def _checked(name, state, *vectors) -> torch.device:
    """The vectors' device, after checking what the kernels index without
    bounds checks: one device, one dtype the kernels take, 1-D contiguous
    vectors of one length, and a float64 state with a slot for every
    block."""
    devices = {t.device for t in (state, *vectors)}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on different devices "
                         f"{sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on cpu or cuda tensors, not {device}")
    dtypes = {t.dtype for t in vectors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _SUFFIX:
        raise TypeError(f"{name}: the vectors must share one of float32, "
                        f"float64, complex64 or complex128, not {dtypes}")
    n = vectors[0].numel()
    for t in vectors:
        if t.ndim != 1 or t.numel() != n:
            raise ValueError(f"{name}: vectors of shapes "
                             f"{[tuple(v.shape) for v in vectors]}")
        if device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous vectors")
    if (state.dtype != torch.float64 or state.ndim != 1
            or not state.is_contiguous()
            or (device.type == "cuda"
                and state.numel() < SLOTS + _blocks(n, device))):
        raise ValueError(f"{name}: state must come from cg_state for "
                         "vectors of this length")
    return device


def _launch(stem, dtype, *args) -> None:
    lib = _build.load_library()
    fn = getattr(lib, f"slt_{stem}_{_SUFFIX[dtype]}")
    _build.check(lib, fn(*args), f"{stem} launch")


def _geometry(n, device):
    return (n, _blocks(n, device), device.index,
            torch.cuda.current_stream(device).cuda_stream)


def cg_pq(p: torch.Tensor, q: torch.Tensor, state: torch.Tensor) -> None:
    """alpha = gamma / Re(p^H q) in ``state``, unless stopped."""
    device = _checked("cg_pq", state, p, q)
    if device.type == "cpu":
        cg_pq_plain(p, q, state)
        return
    _launch("cg_pq", p.dtype, p.data_ptr(), q.data_ptr(), state.data_ptr(),
            *_geometry(p.numel(), device))
    cg_pq.launches += 1


cg_pq.launches = 0


def cg_update(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
              q: torch.Tensor, state: torch.Tensor) -> None:
    """x += alpha p and r -= alpha q in place, then gamma, beta, the
    iteration count and the stop flag in ``state``, unless stopped."""
    device = _checked("cg_update", state, x, r, p, q)
    if device.type == "cpu":
        cg_update_plain(x, r, p, q, state)
        return
    _launch("cg_update", x.dtype, x.data_ptr(), r.data_ptr(), p.data_ptr(),
            q.data_ptr(), state.data_ptr(), *_geometry(x.numel(), device))
    cg_update.launches += 1


cg_update.launches = 0


def cg_direction(p: torch.Tensor, r: torch.Tensor,
                 state: torch.Tensor) -> None:
    """p = r + beta p in place, unless stopped."""
    device = _checked("cg_direction", state, p, r)
    if device.type == "cpu":
        cg_direction_plain(p, r, state)
        return
    _launch("cg_direction", p.dtype, p.data_ptr(), r.data_ptr(),
            state.data_ptr(), *_geometry(p.numel(), device))
    cg_direction.launches += 1


cg_direction.launches = 0
