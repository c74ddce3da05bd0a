"""Logging helpers.

Port of the JAX package's ``hpclinalg/utils/io.py`` (ref: ``io0(io;
r=Set([0]))`` returns devnull off rank 0, HPCLinearAlgebra.jl:802-805).
The rank is the ``torch.distributed`` rank when a process group is up,
else 0.
"""

from __future__ import annotations

import os
import sys


def process_rank() -> int:
    """This process's rank in the default process group, or 0 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def io0(stream=None, ranks={0}):
    """``stream`` (default stdout) on a rank in ``ranks``, else a sink."""
    stream = stream if stream is not None else sys.stdout
    if process_rank() in ranks:
        return stream
    return open(os.devnull, "w")


def show(obj, stream=None, max_elems: int = 200) -> str:
    """Print a distributed container gathered whole (ref: Base.show,
    HPCLinearAlgebra.jl:941-1005): O(n) traffic by design, a debugging aid
    cut off past ``max_elems`` entries. Returns the text."""
    import numpy as np

    out = [repr(obj)]
    if hasattr(obj, "to_scipy"):  # DistSparseMatrix
        M = obj.to_scipy().tocoo()
        k = min(M.nnz, max_elems)
        for t in range(k):
            out.append(f"  [{M.row[t]}, {M.col[t]}]  =  {M.data[t]}")
        if M.nnz > k:
            out.append(f"  ... ({M.nnz - k} more stored entries)")
    elif hasattr(obj, "to_numpy"):  # DistVector / DistDenseMatrix
        with np.printoptions(threshold=max_elems, edgeitems=4):
            out.append(str(obj.to_numpy()))
    s = "\n".join(out)
    print(s, file=io0(stream))
    return s
