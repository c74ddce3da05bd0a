"""The damped 2-D Helmholtz operator of PETSc's ex11.c, in plain PyTorch.

ex11.c solves -Δu - σ₁u + iσ₂u = f on the unit square with homogeneous
Dirichlet sides, by the 5-point stencil scaled by h². On a k x k grid of
interior points, rows ordered with ix fastest, the operator of one
frequency and medium is

    (A x)_i = (4 - s μ_i (1 - iη)) x_i - Σ_{j ∈ 4 grid neighbours of i} x_j,

with x_j = 0 off the grid: σ₁h² = s μ_i and σ₂h² = η s μ_i, where
s = (2π / ppw)² for ppw grid points a wavelength and μ (k, k) is the
relative squared slowness of the medium. A is complex-symmetric (Aᵀ = A,
not Hermitian), and its imaginary part η s diag(μ) is definite for η > 0.
"""

from __future__ import annotations

import torch


def apply(s, mu: torch.Tensor, eta: float, X: torch.Tensor) -> torch.Tensor:
    """A X in complex128 for the scale ``s`` (a float or 0-d tensor), the
    slowness ``mu`` (k, k) and the damping ``eta``; X is (k * k,) or
    (k * k, m)."""
    c128 = torch.complex128
    k = mu.shape[0]
    Xg = X.to(c128).reshape(k, k, -1)
    d = 4 - s * mu.to(torch.float64) * (1 - 1j * eta)
    Y = d.to(c128)[:, :, None] * Xg
    Y[:, 1:] -= Xg[:, :-1]
    Y[:, :-1] -= Xg[:, 1:]
    Y[1:, :] -= Xg[:-1, :]
    Y[:-1, :] -= Xg[1:, :]
    return Y.reshape(X.shape)


def relative_residuals(s, mu: torch.Tensor, eta: float, X: torch.Tensor,
                       B: torch.Tensor) -> torch.Tensor:
    """Each column's ||b - A x|| / ||b|| in complex128, as f64: (m,) for
    X and B (k * k, m), one value for (k * k,)."""
    c128 = torch.complex128
    X2 = X.to(c128).reshape(X.shape[0], -1)
    B2 = B.to(c128).reshape(B.shape[0], -1)
    R = B2 - apply(s, mu, eta, X2)
    nrm = torch.linalg.vector_norm
    return (nrm(R, dim=0) / nrm(B2, dim=0)).to(torch.float64)
