"""LazyTranspose: deferred transpose with the reference's algebra rules.

Port of the JAX package's ``hpclinalg/lazy.py`` (ref: lazy transpose
algebra, sparse.jl:2318-2379, vectors.jl:738): ``Aᵀ @ Bᵀ = (B @ A)ᵀ`` stays
lazy; ``Aᵀ @ B``, ``A @ Bᵀ`` and ``Aᵀ @ x`` materialise the (cached)
transpose. The dense-matrix rules wait for the port's dense slice.
"""

from __future__ import annotations

import numpy as np
import torch

_DENSE = ("dense matrices arrive with the port's dense slice "
          "(dense.py, ops/mixed.py)")


def _is_scalar(o) -> bool:
    return isinstance(o, (int, float, complex, np.number))


class LazyTranspose:
    __array_priority__ = 130

    def __init__(self, parent):
        self.parent = parent

    @property
    def T(self):
        return self.parent

    @property
    def shape(self):
        shp = self.parent.shape
        if len(shp) == 1:  # row vector: transpose(v)
            return (1, shp[0])
        m, n = shp
        return (n, m)

    def materialize(self):
        from .sparse import DistSparseMatrix

        if not isinstance(self.parent, DistSparseMatrix):
            raise NotImplementedError(
                f"materialize of a transposed {type(self.parent).__name__}: "
                + _DENSE)
        return self.parent.transpose_materialized()

    def __matmul__(self, o):
        from .sparse import DistSparseMatrix
        from .vector import DistVector

        p = self.parent
        if isinstance(p, DistVector):
            # row-vector algebra (ref: transpose(v) handling, vectors.jl:738)
            if isinstance(o, DistVector):
                # transpose(v) @ w — plain (non-conjugating) inner product
                w = p._aligned(o)
                dt = torch.promote_types(p.data.dtype, w.data.dtype)
                return torch.sum(p.data.to(dt) * w.data.to(dt))
            if isinstance(o, DistSparseMatrix):
                return LazyTranspose(o.T @ p)       # vᵀ A = (Aᵀ v)ᵀ
            if isinstance(o, LazyTranspose) \
                    and isinstance(o.parent, DistSparseMatrix):
                return LazyTranspose(o.parent @ p)  # vᵀ Aᵀ = (A v)ᵀ
            return NotImplemented
        if not isinstance(p, DistSparseMatrix):
            raise NotImplementedError(
                f"products of a transposed {type(p).__name__}: " + _DENSE)
        if isinstance(o, DistVector):
            return self.materialize() @ o
        if isinstance(o, LazyTranspose):
            # Aᵀ @ Bᵀ = (B @ A)ᵀ — stays lazy (ref sparse.jl:2318)
            return LazyTranspose(o.parent @ p)
        if isinstance(o, DistSparseMatrix):
            return self.materialize() @ o
        return NotImplemented

    def __mul__(self, scalar):
        if _is_scalar(scalar):
            return LazyTranspose(self.parent * scalar)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, o):
        if _is_scalar(o):
            return LazyTranspose(self.parent / o)
        return NotImplemented

    def __neg__(self):
        return LazyTranspose(-self.parent)

    def __add__(self, o):
        if isinstance(o, LazyTranspose):
            return LazyTranspose(self.parent + o.parent)
        return self.materialize() + o

    def __sub__(self, o):
        if isinstance(o, LazyTranspose):
            return LazyTranspose(self.parent - o.parent)
        return self.materialize() - o

    def to_scipy(self):
        if not hasattr(self.parent, "to_scipy"):
            raise TypeError(
                f"to_scipy is only available for sparse parents, "
                f"not {type(self.parent).__name__}")
        return self.parent.to_scipy().T.tocsr()

    def __repr__(self):
        return f"LazyTranspose({self.parent!r})"
