"""The variable-coefficient 2-D diffusion operator, in plain PyTorch.

On a k x k grid with homogeneous Dirichlet boundaries (PETSc's
``src/ksp/ksp/tutorials/ex2.c`` 5-point Laplacian, whose edges all conduct
1), each grid edge conducts c > 0, and

    (A x)_i = sum over the four edges e = (i, j) of i of c_e (x_i - x_j),

with x_j = 0 for the boundary's points. ``ch[iy, j]`` (k, k + 1) is the edge
between (iy, j - 1) and (iy, j); ``cv[j, ix]`` (k + 1, k) the edge between
(j - 1, ix) and (j, ix); rows are ordered with ix fastest. A is SPD for any
positive conductivities, and with all of them 1 it is laplace2d(k).
"""

from __future__ import annotations

import torch


def apply(ch: torch.Tensor, cv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for the conductivities ``ch`` (k, k + 1) and ``cv`` (k + 1, k);
    x is (k * k,)."""
    k = ch.shape[0]
    X = x.reshape(k, k)
    d = ch[:, :-1] + ch[:, 1:] + cv[:-1, :] + cv[1:, :]
    Y = d * X
    inner_h = ch[:, 1:k]          # edges between (iy, ix) and (iy, ix + 1)
    inner_v = cv[1:k, :]          # edges between (iy, ix) and (iy + 1, ix)
    Y[:, 1:] -= inner_h * X[:, :-1]
    Y[:, :-1] -= inner_h * X[:, 1:]
    Y[1:, :] -= inner_v * X[:-1, :]
    Y[:-1, :] -= inner_v * X[1:, :]
    return Y.reshape(-1)


def relative_residual(ch, cv, x: torch.Tensor, b: torch.Tensor) -> float:
    """||b - A x|| / ||b|| in f64."""
    f64 = torch.float64
    x, b = x.to(f64), b.to(f64)
    r = b - apply(ch.to(f64), cv.to(f64), x)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
