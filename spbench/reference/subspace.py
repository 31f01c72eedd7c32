"""How far a block of eigenvectors is from orthonormal, in plain PyTorch."""

from __future__ import annotations

import torch


def orthonormality_gap(v: torch.Tensor) -> float:
    """The largest entry of |V^H V - I| for V of shape (n, k)."""
    v = v.to(torch.complex128 if v.is_complex() else torch.float64)
    gram = v.mH @ v
    gram -= torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    return float(gram.abs().max()) if gram.numel() else 0.0
