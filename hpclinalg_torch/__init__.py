"""hpclinalg_torch — the PyTorch/CUDA port of hpclinalg.

Row-partitioned vectors, CSR sparse matrices and dense matrices stored as
stacked-shard tensors on one device; memoized exchange, SpMV, SpMM,
transpose, addition and SpGEMM plans; hand-written Hopper kernels for the
DIA, ELL and resident-x ELL SpMV engines and for the DIA and k-payload
probes (``csrc/``, driven by ``hpclinalg_torch.tools``); and the host C++
multifrontal direct solver.
The JAX package ``hpclinalg`` is the reference it is tested against; this
package never imports it or JAX.
"""

from .backend import Backend, backend_auto, backends_compatible
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
from .solver.api import BackslashCache, Factorization, Symmetric, ldlt, lu, solve
from .utils.convert import from_reference

__all__ = [
    "Backend", "backend_auto", "backends_compatible",
    "cache_sizes", "check_cache_sizes", "clear_plan_cache",
    "dense_structural_hash", "partition_hash", "sparse_structural_hash",
    "uniform_partition",
    "DistVector", "DistSparseMatrix", "DistDenseMatrix", "LazyTranspose",
    "diag", "dropzeros", "tril", "triu", "repartition",
    "repartition_dense", "repartition_vector",
    "spdiagm", "speye", "sprand_dist", "spzeros",
    "BackslashCache", "Factorization", "Symmetric", "ldlt", "lu", "solve",
    "from_reference",
]
