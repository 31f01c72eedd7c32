"""Hopper kernels for DIA SpMV: wrappers around ``csrc/dia_spmv.cu``.

Counterpart of :mod:`sparse_linear_tpu.kernels.spmv_pallas`.

* :func:`dia_spmv_kernel` (kernel A) replaces both TPU kernels behind
  ``dia_spmv_pallas``: the blocked-halo kernel (``_blocked_kernel``,
  ``_dia_spmv_blocked``) and the streaming kernel (``_stream_kernel``,
  ``_dia_spmv_streamed``).  One CUDA kernel takes any shape.
* :func:`dia_spmv_chain` (kernel B) replaces ``_chain_kernel`` /
  ``dia_spmv_chain``: y = (alpha A)^k x in one cooperative launch.

A wrapper takes the plain PyTorch version (:func:`.spmv.dia_spmv`) only
because its tensors lie on the CPU.  On CUDA tensors it launches its kernel
on the current stream or raises; nothing falls back.  Each wrapper counts
its kernel launches in ``.launches`` (a plain int; set it to 0 to reset).
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.kernels import _build
from sparse_linear_tpu_torch.kernels.spmv import dia_spmv

__all__ = ["dia_spmv_kernel", "dia_spmv_chain"]

_KERNEL_DTYPES = (torch.float32, torch.float64)


def _device_of(name, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"{name}: operands on different devices "
            f"{sorted(str(d) for d in devices)}"
        )
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on cpu or cuda tensors, not {device}")
    return device


def _flat(name, dia, x):
    """``x`` as a 1-D vector of length ncols, and the row width to give the
    result back in when ``x`` came pre-tiled (2-D with ncols elements, as
    the JAX package's ``(n // 128, 128)`` layout), else None.  Also checks
    that ``data`` holds one row of nrows entries per offset, which the
    kernels index without bounds checks."""
    nr, nc = dia.shape
    if tuple(dia.data.shape) != (len(dia.offsets), nr):
        raise ValueError(
            f"{name}: DIA data of shape {tuple(dia.data.shape)} does not "
            f"match {len(dia.offsets)} offsets x {nr} rows")
    if x.ndim == 2 and x.numel() == nc:
        return x.reshape(-1), x.shape[1]
    if x.ndim != 1 or x.shape[0] != nc:
        raise ValueError(
            f"{name}: dimension mismatch {dia.shape} @ {tuple(x.shape)}")
    return x, None


def _kernel_dtype(name, dtype) -> None:
    if dtype.is_complex:
        raise TypeError(
            f"{name}: complex DIA on CUDA is not ported yet (ROADMAP.md "
            "queue 1 item 10: complex instantiations of the DIA kernels); "
            "complex runs on CPU tensors through the plain version"
        )
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, "
                        f"not {dtype}")


def _alpha(alpha) -> float:
    return 1.0 if alpha is None else float(alpha)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dia_spmv_kernel(dia, x: torch.Tensor, alpha=None) -> torch.Tensor:
    """y = (alpha *) A @ x for DIA storage.

    Any shape (rectangular, unaligned, wide offsets).  ``data`` and ``x``
    are promoted to ``torch.result_type(data, x)`` first.  ``x`` may come
    pre-tiled as a 2-D tensor with ncols elements; y then comes back in
    rows of the same width.  ``alpha`` is fused into the store.
    """
    name = "dia_spmv_kernel"
    device = _device_of(name, dia.data, x)
    xf, width = _flat(name, dia, x)
    if device.type == "cpu":
        y = dia_spmv(dia, xf)
        if alpha is not None:
            y = y * alpha
    else:
        y = _launch_spmv(dia, xf, alpha, device)
    return y if width is None else y.reshape(-1, width)


def _launch_spmv(dia, x, alpha, device):
    nr, nc = dia.shape
    dtype = torch.result_type(dia.data, x)
    _kernel_dtype("dia_spmv_kernel", dtype)
    data = dia.data.to(dtype).contiguous()
    x = x.to(dtype).contiguous()
    y = torch.empty((nr,), dtype=dtype, device=device)
    if nr == 0:
        return y
    lib = _build.load_library()
    fn = lib.slt_dia_spmv_f32 if dtype == torch.float32 else lib.slt_dia_spmv_f64
    code = fn(data.data_ptr(), dia.offsets_tensor.data_ptr(), x.data_ptr(),
              y.data_ptr(), len(dia.offsets), nr, nc, _alpha(alpha),
              device.index, _stream(device))
    _build.check(lib, code, "dia_spmv_kernel launch")
    dia_spmv_kernel.launches += 1
    return y


dia_spmv_kernel.launches = 0


def dia_spmv_chain(dia, x: torch.Tensor, k: int, alpha=None) -> torch.Tensor:
    """y = (alpha A)^k @ x in ONE kernel launch (the iterative-method hot
    loop: power or Chebyshev iteration).

    A persistent cooperative grid runs the k steps with a grid-wide barrier
    between them and two ping-pong vectors.  ``x`` is cast to the data
    dtype and so is the result.  Square operators only; ``k >= 1``.  The
    JAX kernel's 1024-row alignment and 120 MB budget are VMEM limits and
    do not apply: any square size runs.  The H100 has no 128 MB scratchpad
    for the operator, and its 50 MB L2 holds the 84 MB f32 2048**2 Poisson
    operator only in part.
    """
    nr, nc = dia.shape
    if nr != nc:
        raise ValueError("dia_spmv_chain: square shapes only")
    if k < 1:
        raise ValueError("dia_spmv_chain: k must be >= 1")
    name = "dia_spmv_chain"
    device = _device_of(name, dia.data, x)
    xf, width = _flat(name, dia, x)
    xf = xf.to(dia.data.dtype)
    if device.type == "cpu":
        y = xf
        for _ in range(k):
            y = dia_spmv(dia, y)
            if alpha is not None:
                y = y * alpha
    else:
        y = _launch_chain(dia, xf, int(k), alpha, device)
    return y if width is None else y.reshape(-1, width)


def _launch_chain(dia, x, k, alpha, device):
    n = dia.shape[0]
    dtype = dia.data.dtype
    _kernel_dtype("dia_spmv_chain", dtype)
    if k >= 2**31:
        raise ValueError("dia_spmv_chain: k must be < 2**31")
    data = dia.data.contiguous()
    x = x.contiguous()
    bufs = (torch.empty((n,), dtype=dtype, device=device),)
    bufs += (torch.empty_like(bufs[0]),) if k > 1 else bufs
    if n == 0:
        return bufs[0]
    lib = _build.load_library()
    fn = lib.slt_dia_chain_f32 if dtype == torch.float32 else lib.slt_dia_chain_f64
    code = fn(data.data_ptr(), dia.offsets_tensor.data_ptr(), x.data_ptr(),
              bufs[0].data_ptr(), bufs[1].data_ptr(), len(dia.offsets), n, k,
              _alpha(alpha), device.index, _stream(device))
    _build.check(lib, code, "dia_spmv_chain launch")
    dia_spmv_chain.launches += 1
    return bufs[(k - 1) % 2]


dia_spmv_chain.launches = 0
