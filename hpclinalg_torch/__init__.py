"""hpclinalg_torch — the PyTorch/CUDA port of hpclinalg.

Row-partitioned vectors, CSR sparse matrices and dense matrices stored as
stacked-shard tensors on one device, or one shard a process over a
``torch.distributed`` process group (``backend_dist``; every operation
runs on a group); memoized exchange, SpMV, SpMM, transpose, addition and
SpGEMM plans; hand-written Hopper kernels for the DIA, ELL and
resident-x ELL SpMV engines and for the DIA and k-payload probes
(``csrc/``, driven by ``hpclinalg_torch.tools``); indexing, index
assignment, block assembly, sparse reductions and ``map_rows``; the host
C++ and device multifrontal direct solvers; and, in
``hpclinalg_torch.entry`` (outside ``__all__``, as the JAX package keeps
its entry point in ``__graft_entry__``), the CG step over a plan's raw
tensors (``cg_step_fn``), the JAX entry point's ``entry()``, and
``capture``, the step captured once as a CUDA graph and replayed.
The JAX package ``hpclinalg`` is the reference it is tested against; this
package never imports it or JAX.
"""

from .backend import (Backend, backend_auto, backend_dist, backend_serial,
                      backends_compatible)
from .cache import cache_sizes, check_cache_sizes, clear_plan_cache
from .hashing import (dense_structural_hash, partition_hash,
                      sparse_structural_hash)
from .partition import uniform_partition
from .vector import DistVector
from .sparse import DistSparseMatrix
from .dense import DistDenseMatrix
from .lazy import LazyTranspose
from .ops.diagonal import diag, dropzeros, tril, triu
from .ops.repartition import (repartition, repartition_dense,
                              repartition_vector)
from .ops.sparse_build import spdiagm, speye, sprand_dist, spzeros
from .ops.blocks import (blockdiag, cat, cat_dense, cat_sparse, hcat_dense,
                         hcat_sparse, hcat_vectors, vcat_dense, vcat_sparse,
                         vcat_vectors)
from .ops.map_rows import map_rows, vertex_indices
from .solver.api import BackslashCache, Factorization, Symmetric, ldlt, lu, solve
from .utils.convert import (clear_solver_caches, comm_rank, comm_size,
                            from_reference, to_backend)
from .utils.io import io0, show
from .utils.profiling import (annotate, profile_trace, span,
                              trace_report, tracing)
from .utils.warmup import warmup

__all__ = [
    "Backend", "backend_auto", "backend_dist", "backend_serial",
    "backends_compatible",
    "cache_sizes", "check_cache_sizes", "clear_plan_cache",
    "dense_structural_hash", "partition_hash", "sparse_structural_hash",
    "uniform_partition",
    "DistVector", "DistSparseMatrix", "DistDenseMatrix", "LazyTranspose",
    "diag", "dropzeros", "tril", "triu", "repartition",
    "repartition_dense", "repartition_vector",
    "spdiagm", "speye", "sprand_dist", "spzeros",
    "BackslashCache", "Factorization", "Symmetric", "ldlt", "lu", "solve",
    "blockdiag", "cat", "cat_sparse", "hcat_sparse", "vcat_sparse",
    "cat_dense", "hcat_dense", "vcat_dense", "vcat_vectors", "hcat_vectors",
    "map_rows", "vertex_indices", "io0", "show", "warmup", "profile_trace",
    "annotate", "span", "tracing", "trace_report", "to_backend",
    "comm_rank", "comm_size", "clear_solver_caches", "from_reference",
]
