"""HPCG's operator and its unpreconditioned conjugate gradient, in plain
PyTorch.

The operator is HPCG 3.1's 27-point stencil (``GenerateProblem_ref.cpp``):
26 on the diagonal and -1 for each of the up to 26 neighbours of a grid
point inside the (nx, ny, nz) grid, rows ordered with x fastest
(row = ix + nx * (iy + ny * iz)). It is applied here as a sum of the 27
shifted copies of the zero-padded grid, never from a stored matrix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stencil27(x: torch.Tensor, dims) -> torch.Tensor:
    """A @ x for the 27-point operator on the grid ``dims`` = (nx, ny, nz);
    x is (..., nx * ny * nz)."""
    nx, ny, nz = dims
    lead = x.shape[:-1]
    X = x.reshape(*lead, nz, ny, nx)
    P = F.pad(X, (1, 1, 1, 1, 1, 1))
    s = torch.zeros_like(X)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                s += P[..., dz:dz + nz, dy:dy + ny, dx:dx + nx]
    # the 27 copies include the point itself: 27 x - s = 26 x - neighbours
    return (27 * X - s).reshape(*lead, nx * ny * nz)


def cg(apply, b: torch.Tensor, iters: int):
    """``iters`` steps of unpreconditioned CG from x = 0 on A = ``apply``,
    in b's dtype, in the textbook order (Saad, Algorithm 6.18): returns the
    iterate and the residual after the last step."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    for _ in range(iters):
        Ap = apply(p)
        rr = torch.dot(r, r)
        alpha = rr / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        beta = torch.dot(r, r) / rr
        p = r + beta * p
    return x, r
