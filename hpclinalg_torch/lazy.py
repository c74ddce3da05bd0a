"""LazyTranspose: deferred transpose with the reference's algebra rules.

Port of the JAX package's ``hpclinalg/lazy.py`` (ref: lazy transpose
algebra, sparse.jl:2318-2379, vectors.jl:738, dense.jl:952-982):
``Aᵀ @ Bᵀ = (B @ A)ᵀ`` stays lazy; ``Aᵀ @ B``, ``A @ Bᵀ`` and ``Aᵀ @ x``
materialise the transpose, except a dense ``Dᵀ @ x``, which sums the
shards' partial products without materialising (``rmatvec``); right
division ``vᵀ / A`` solves the transposed system. On a process group
each of these runs as its stacked form does (the transpose's exchange,
the host solve on rank 0, ``vᵀ w`` and the dense ``Dᵀ @ x``'s partial
products all-reduced).
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel import comm


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

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def backend(self):
        return self.parent.backend

    def materialize(self):
        if not hasattr(self.parent, "transpose_materialized"):
            raise TypeError(f"a transposed {type(self.parent).__name__} is a "
                            "row vector and has no materialised form")
        return self.parent.transpose_materialized()

    def __matmul__(self, o):
        from .dense import DistDenseMatrix
        from .sparse import DistSparseMatrix
        from .vector import DistVector

        p = self.parent
        if isinstance(p, DistVector):
            # row-vector algebra (ref: transpose(v) handling, vectors.jl:738)
            if isinstance(o, DistVector):
                # transpose(v) @ w — plain (non-conjugating) inner product
                w = p._aligned(o)
                dt = torch.promote_types(p.data.dtype, w.data.dtype)
                return comm.all_reduce(p.backend, torch.sum(
                    p.data.to(dt) * w.data.to(dt)))
            if isinstance(o, (DistSparseMatrix, DistDenseMatrix)):
                return LazyTranspose(o.T @ p)       # vᵀ A = (Aᵀ v)ᵀ
            if isinstance(o, LazyTranspose):
                return LazyTranspose(o.parent @ p)  # vᵀ Aᵀ = (A v)ᵀ
            return NotImplemented
        if isinstance(o, DistVector):
            if isinstance(p, DistDenseMatrix):
                return p.rmatvec(o)  # no materialisation (dense.jl:1000-1261)
            return self.materialize() @ o
        if isinstance(o, LazyTranspose):
            # Aᵀ @ Bᵀ = (B @ A)ᵀ — stays lazy (ref sparse.jl:2318)
            return LazyTranspose(o.parent @ p)
        if isinstance(o, (DistSparseMatrix, DistDenseMatrix)):
            return self.materialize() @ o
        return NotImplemented

    def __mul__(self, scalar):
        if _is_scalar(scalar):
            return LazyTranspose(self.parent * scalar)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, o):
        """Right division (ref: HPCLinearAlgebra.jl:713-744):
        ``vᵀ / A = (Aᵀ \\ v)ᵀ`` and ``vᵀ / Aᵀ = (A \\ v)ᵀ``."""
        from .sparse import DistSparseMatrix
        from .vector import DistVector

        if isinstance(self.parent, DistVector):
            from .solver.api import solve

            if isinstance(o, LazyTranspose) \
                    and isinstance(o.parent, DistSparseMatrix):
                return LazyTranspose(solve(o.parent, self.parent))
            if isinstance(o, DistSparseMatrix):
                return LazyTranspose(solve(LazyTranspose(o), self.parent))
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

    def __radd__(self, o):
        # o + Aᵀ where o's own __add__ punted (e.g. dense + lazy dense)
        return o + self.materialize()

    def __rsub__(self, o):
        return o - self.materialize()

    def to_numpy(self):
        mat = self.parent
        if hasattr(mat, "to_scipy"):
            return mat.to_scipy().T
        arr = mat.to_numpy()
        if arr.ndim == 1:  # row vector: match self.shape == (1, n)
            return arr.reshape(1, -1)
        return arr.T

    def to_scipy(self):
        if not hasattr(self.parent, "to_scipy"):
            raise TypeError(
                f"to_scipy is only available for sparse parents, "
                f"not {type(self.parent).__name__}; use to_numpy()")
        return self.parent.to_scipy().T.tocsr()

    def __repr__(self):
        return f"LazyTranspose({self.parent!r})"
