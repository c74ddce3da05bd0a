"""Block operations: cat, hcat, vcat and blockdiag.

Port of the JAX package's ``hpclinalg/ops/blocks.py`` (ref: blocks.jl:30-547).
The output structure of a sparse concatenation is assembled on the host
from the blocks' replicated structures (``sparse_index.assemble``, the
same structure and hash as the JAX package's), and each block scatters its
values into the shared output through one cached ``ExchangePlan``. Every
block is promoted to the common dtype before its scatter, so an f64 block
never lands in an f32 output. On a process group every rank assembles the
same structure and plans and scatters its own shard's values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cache import cached_plan
from ..partition import uniform_partition
from .sparse_index import assemble


def _common_dtype(blocks) -> torch.dtype:
    dt = blocks[0].dtype
    for b in blocks[1:]:
        dt = torch.promote_types(dt, b.dtype)
    return dt


def _assemble_blocks(backend, placed):
    """The output structure and one value ExchangePlan per block.
    ``placed``: (block, row offset, column offset) in the output."""
    S = backend.nshards
    M = max((b.m + ro for b, ro, _ in placed), default=0)
    N = max((b.ncols + co for b, _, co in placed), default=0)
    rows, cols, group, src, pos = [], [], [], [], []
    for bid, (B, ro, co) in enumerate(placed):
        st = B.structure
        for s in range(S):
            r, c = st.global_coo[s]
            rows.append(r + ro)
            cols.append(c + co)
            group.append(np.full(len(r), bid, np.int64))
            src.append(np.full(len(r), s, np.int64))
            pos.append(np.arange(len(r), dtype=np.int64))
    cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int64))
    return assemble(backend, uniform_partition(M, S), uniform_partition(N, S),
                    cat(rows), cat(cols), cat(group), cat(src), cat(pos),
                    len(placed))


def _run_blocks(backend, key, placed):
    from ..sparse import DistSparseMatrix

    st, plans = cached_plan("blocks_plan", key,
                            lambda: _assemble_blocks(backend, placed))
    dtype = _common_dtype([B for B, _ro, _co in placed])
    out = None
    for plan, (B, _ro, _co) in zip(plans, placed):
        out = plan.apply(B.nzval.to(dtype), base=out)
    return DistSparseMatrix(st, out, backend)


def _grid_offsets(blocks, dims):
    """Arrange blocks row-major in a grid and check that heights agree along
    a grid row and widths along a grid column: (grid, row offsets, column
    offsets)."""
    if isinstance(dims, tuple):
        bm, bn = dims
        if len(blocks) != bm * bn:
            raise ValueError("block count does not match grid")
        grid = [list(blocks[i * bn:(i + 1) * bn]) for i in range(bm)]
    elif dims == 1:
        grid = [[b] for b in blocks]
    elif dims == 2:
        grid = [list(blocks)]
    else:
        raise ValueError("dims must be 1, 2 or a (nrows, ncols) tuple")
    row_off = [0]
    for brow in grid:
        h = brow[0].m
        if any(b.m != h for b in brow):
            raise ValueError("inconsistent block heights in a grid row")
        row_off.append(row_off[-1] + h)
    col_off = [0]
    for j in range(len(grid[0])):
        w = grid[0][j].ncols
        if any(brow[j].ncols != w for brow in grid):
            raise ValueError("inconsistent block widths in a grid column")
        col_off.append(col_off[-1] + w)
    return grid, row_off, col_off


def cat_sparse(*blocks, dims=1):
    """Concatenate sparse blocks (ref: cat, blocks.jl:30-127): ``dims`` 1
    stacks them vertically, 2 horizontally, (bm, bn) in a row-major grid."""
    grid, row_off, col_off = _grid_offsets(blocks, dims)
    backend = grid[0][0].backend
    placed = [(b, row_off[i], col_off[j])
              for i, brow in enumerate(grid) for j, b in enumerate(brow)]
    key = ("cat", tuple(tuple(b.hash for b in brow) for brow in grid),
           backend.key)
    return _run_blocks(backend, key, placed)


def vcat_sparse(*blocks):
    return cat_sparse(*blocks, dims=1)


def hcat_sparse(*blocks):
    return cat_sparse(*blocks, dims=2)


def blockdiag(*blocks):
    """Blocks on the diagonal (ref: blockdiag, blocks.jl:467); the zero
    blocks off the diagonal are never formed."""
    backend = blocks[0].backend
    placed, ro, co = [], 0, 0
    for B in blocks:
        placed.append((B, ro, co))
        ro += B.m
        co += B.ncols
    key = ("blockdiag", tuple(b.hash for b in blocks), backend.key)
    return _run_blocks(backend, key, placed)


def cat_dense(*blocks, dims=1):
    """Concatenate distributed dense matrices (ref: cat for HPCMatrix,
    blocks.jl:183): each block's rows move through one cached ExchangePlan
    with whole-row payloads and land in their column range."""
    from ..dense import DistDenseMatrix
    from ..hashing import partition_hash
    from ..partition import padded_size
    from .gather import scatter_exchange_plan

    grid, row_off, col_off = _grid_offsets(blocks, dims)
    backend = grid[0][0].backend
    S = backend.nshards
    M, N = row_off[-1], col_off[-1]
    rp2 = uniform_partition(M, S)
    dtype = _common_dtype(blocks)
    out = torch.zeros((backend.nlocal, padded_size(rp2), N), dtype=dtype,
                      device=backend.device)
    p2h = partition_hash(rp2)
    for i, brow in enumerate(grid):
        for j, B in enumerate(brow):
            ro = row_off[i]

            def build(B=B, ro=ro):
                dst = [ro + np.arange(B.row_partition[s], B.row_partition[s + 1])
                       for s in range(S)]
                return scatter_exchange_plan(backend, B.row_partition, dst, rp2)

            plan = cached_plan(
                "dense_cat_rows",
                (partition_hash(B.row_partition), p2h, ro, backend.key), build)
            out[:, :, col_off[j]:col_off[j + 1]] += plan.apply(B.data.to(dtype))
    return DistDenseMatrix(out, rp2, N, backend)


def vcat_dense(*blocks):
    return cat_dense(*blocks, dims=1)


def hcat_dense(*blocks):
    return cat_dense(*blocks, dims=2)


def vcat_vectors(*vs):
    """Concatenate distributed vectors (ref: vcat for HPCVector,
    blocks.jl:304-445): one cached scatter ExchangePlan per input."""
    from ..hashing import partition_hash
    from ..vector import DistVector
    from .gather import scatter_exchange_plan

    backend = vs[0].backend
    S = backend.nshards
    p2 = uniform_partition(sum(len(v) for v in vs), S)
    p2h = partition_hash(p2)
    dtype = _common_dtype(vs)
    out, off = None, 0
    for v in vs:
        def build(v=v, off=off):
            dst = [off + np.arange(v.partition[s], v.partition[s + 1])
                   for s in range(S)]
            return scatter_exchange_plan(backend, v.partition, dst, p2)

        plan = cached_plan("vec_cat", (v.partition_hash, p2h, off, backend.key),
                           build)
        out = plan.apply(v.data.to(dtype), base=out)
        off += len(v)
    return DistVector(out, p2, backend)


def hcat_vectors(*vs):
    """Vectors side by side as the columns of a dense matrix (ref: hcat for
    HPCVector, blocks.jl:304-445), each aligned to the first's partition."""
    from ..dense import DistDenseMatrix

    v0 = vs[0]
    dtype = _common_dtype(vs)
    cols = [v0.data.to(dtype) if v is v0 else v0._aligned(v).data.to(dtype)
            for v in vs]
    return DistDenseMatrix(torch.stack(cols, dim=2), v0.partition, len(vs),
                           v0.backend)


def cat(*blocks, dims=1):
    """``cat`` over all three container families (ref: blocks.jl:30/183/304)."""
    from ..dense import DistDenseMatrix
    from ..sparse import DistSparseMatrix
    from ..vector import DistVector

    b0 = blocks[0]
    if isinstance(b0, DistSparseMatrix):
        return cat_sparse(*blocks, dims=dims)
    if isinstance(b0, DistDenseMatrix):
        return cat_dense(*blocks, dims=dims)
    if isinstance(b0, DistVector):
        if isinstance(dims, tuple):
            # ref blocks.jl:349-383: dims=(n, 1) is vcat, (1, n) hcat
            m, n = dims
            if m * n != len(blocks):
                raise ValueError("dims grid does not match block count")
            if n == 1:
                return vcat_vectors(*blocks) if m > 1 else blocks[0]
            if m == 1:
                return hcat_vectors(*blocks)
            raise ValueError("vector cat grids must be (n,1) or (1,n)")
        if dims == 2:
            return hcat_vectors(*blocks)
        if dims != 1:
            raise ValueError("vectors concatenate along dims=1 (vcat) or "
                             "dims=2 (hcat -> dense matrix)")
        return vcat_vectors(*blocks)
    raise TypeError(f"unsupported block type {type(b0)}")
