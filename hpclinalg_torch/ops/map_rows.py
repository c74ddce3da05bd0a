"""map_rows: a row-wise map over aligned distributed containers.

Port of the JAX package's ``hpclinalg/ops/map_rows.py`` (ref: map_rows,
HPCLinearAlgebra.jl:1017-1249): every argument is repartitioned to the
first argument's partition, then ``fn`` runs on each row through
``torch.func.vmap`` twice over this process's (nlocal, L, ...) data: all
S shards stacked, or its own on a process group, where the repartition is
an exchange. ``fn`` takes and returns torch tensors.

vertex_indices (ref HPCLinearAlgebra.jl:1286) is the global row index
vector of a partition, 0-based.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import torch_dtype


def map_rows(fn, *args, out_dtype=None):
    """Apply ``fn`` row by row. Each argument is a DistVector or a
    DistDenseMatrix, and all are repartitioned to the first argument's
    partition. ``fn`` gets one scalar (vector argument) or one (ncols,) row
    (dense argument) per argument and returns a scalar (the result is a
    DistVector) or a row of fixed length (a DistDenseMatrix)."""
    from ..dense import DistDenseMatrix
    from ..vector import DistVector, _mask_dev

    v0 = args[0]
    if not isinstance(v0, (DistVector, DistDenseMatrix)):
        raise TypeError(f"map_rows argument of type {type(v0)}")
    backend = v0.backend
    part = v0.partition if isinstance(v0, DistVector) else v0.row_partition
    datas = []
    for a in args:
        if isinstance(a, DistVector):
            ap = a.partition
        elif isinstance(a, DistDenseMatrix):
            ap = a.row_partition
        else:
            raise TypeError(f"map_rows argument of type {type(a)}")
        datas.append((a if np.array_equal(ap, part)
                      else a.repartition(part)).data)

    mapped = torch.func.vmap(torch.func.vmap(fn))(*datas)
    if out_dtype is not None:
        mapped = mapped.to(torch_dtype(out_dtype))
    # fn(0, ...) need not be 0: zero the padding rows again
    mask = _mask_dev(part, mapped.shape[1], backend)
    if mapped.dim() == 2:
        return DistVector(torch.where(mask, mapped, mapped.new_zeros(())),
                          part, backend)
    mapped = torch.where(mask[..., None], mapped, mapped.new_zeros(()))
    return DistDenseMatrix(mapped, part, int(mapped.shape[2]), backend)


def vertex_indices(partition: np.ndarray, backend):
    """The global row index of every row of ``partition`` as an int64
    DistVector on that partition (ref: vertex_indices,
    HPCLinearAlgebra.jl:1286), 0-based."""
    from ..vector import DistVector

    n = int(partition[-1])
    return DistVector.from_global(np.arange(n, dtype=np.int64), backend,
                                  partition=partition, dtype=np.int64)
