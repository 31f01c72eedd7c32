"""A lognormal coefficient field on a grid, made on the device from a seed.

kappa = exp(sigma * g), with g a stationary Gaussian field of unit
variance and exponential covariance exp(-r / ell), ell = ``corr`` times the
longest side of the grid: white noise filtered in Fourier space by the
square root of that covariance's spectral density, (1 + ell^2 k^2) to the
-(d + 1) / 2 (periodic on the grid), normalised so that the field's
variance is 1.  This is the field of the Monte Carlo studies of flow in
porous media (Cliffe, Giles, Scheichl, Teckentrup, Comput. Visual. Sci.
14, 2011: sigma^2 = 1, exponential covariance).
"""

from __future__ import annotations

import math

import torch


def field(grid, sigma: float, corr: float, generator,
          device) -> torch.Tensor:
    """kappa on the nodes of ``grid`` (x fastest), float64."""
    shape = tuple(reversed(grid))
    noise = torch.randn(shape, dtype=torch.float64, device=device,
                        generator=generator)
    ell = corr * max(grid)
    k2 = torch.zeros(shape, dtype=torch.float64, device=device)
    for ax, m in enumerate(shape):
        k = 2 * math.pi * torch.fft.fftfreq(m, device=device,
                                            dtype=torch.float64)
        view = [1] * len(shape)
        view[ax] = m
        k2 = k2 + (k * k).reshape(view)
    dens = (1.0 + ell * ell * k2) ** (-(len(shape) + 1) / 2)
    dens = dens / dens.mean()
    g = torch.fft.ifftn(torch.fft.fftn(noise) * dens.sqrt()).real
    return torch.exp(sigma * g)
