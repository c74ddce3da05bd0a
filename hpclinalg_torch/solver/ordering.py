"""Fill-reducing orderings for the direct solver.

The reference delegates ordering to METIS inside MUMPS (ICNTL(7)=5,
reference src/mumps_factorization.jl:176-185). Approximate Minimum
Degree is implemented from scratch:
the production path is native C++ (native/amd.cpp, loaded via ctypes); a
pure-numpy reverse Cuthill-McKee fallback keeps the solver functional if
the native library is unavailable.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

from collections import deque

import numpy as np

@lru_cache(maxsize=1)
def _load_amd():
    """AMD kernel (native/amd.cpp) via the shared native build/load helper."""
    from .native import build_native_lib

    lib = build_native_lib("hpctorch_amd", "amd.cpp")
    if lib is None:
        return None
    lib.amd_order.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
    ]
    lib.amd_order.restype = ctypes.c_int
    return lib


def symmetrize_pattern(indptr, indices, n):
    """Pattern of A + Aᵀ without the diagonal, CSR."""
    import scipy.sparse as sp

    A = sp.csr_matrix(
        (np.ones(len(indices)), indices, indptr), shape=(n, n)
    )
    B = A + A.T
    B = sp.csr_matrix(B)
    B.setdiag(0)
    B.eliminate_zeros()
    B.sort_indices()
    return B.indptr.astype(np.int64), B.indices.astype(np.int64)


def amd_order(indptr, indices, n) -> np.ndarray:
    """Fill-reducing permutation (new-to-old) of a symmetric pattern."""
    ip, ix = symmetrize_pattern(indptr, indices, n)
    lib = _load_amd()
    if lib is not None:
        perm = np.zeros(n, dtype=np.int64)
        rc = lib.amd_order(n, ip, ix, perm)
        if rc == 0:
            return perm
    return rcm_order(ip, ix, n)


def rcm_order(indptr, indices, n) -> np.ndarray:
    """Reverse Cuthill-McKee, from scratch — BFS from a pseudo-peripheral
    vertex, neighbors visited by increasing degree."""
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    comps = np.argsort(deg, kind="stable")
    for seed in comps:
        if visited[seed]:
            continue
        # pseudo-peripheral: a couple of BFS sweeps
        root = int(seed)
        for _ in range(2):
            lvl = _bfs_last_level(root, indptr, indices, visited)
            if lvl is None:
                break
            root = lvl
        queue = deque([root])
        visited[root] = True
        while queue:
            v = queue.popleft()
            order[pos] = v
            pos += 1
            nbrs = indices[indptr[v]: indptr[v + 1]]
            nbrs = nbrs[~visited[nbrs]]
            nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            for u in nbrs:
                if not visited[u]:
                    visited[u] = True
                    queue.append(int(u))
    return order[::-1].copy()


def _bfs_last_level(root, indptr, indices, visited_mask):
    seen = visited_mask.copy()
    seen[root] = True
    frontier = [root]
    last = root
    while frontier:
        nxt = []
        for v in frontier:
            for u in indices[indptr[v]: indptr[v + 1]]:
                if not seen[u]:
                    seen[u] = True
                    nxt.append(int(u))
        if nxt:
            last = nxt[-1]
        frontier = nxt
    return last


# ---------------------------------------------------------------------------
# nested dissection (George-Liu level-structure bisection)
# ---------------------------------------------------------------------------

def nd_order(indptr, indices, n, leaf: int = 256) -> np.ndarray:
    """Nested-dissection permutation (new-to-old) of a symmetric pattern.

    Role: the reference's METIS ordering (ICNTL(7)=5) produces balanced
    separator trees; AMD's irregular trees serialize the device engine's
    wave schedule on 2D stencil-class grids. This is classic George-Liu
    dissection with BFS level-structure separators: split each component
    at the median BFS level from a pseudo-peripheral vertex, take the
    boundary vertices of the smaller half as the separator, recurse, and
    AMD the leaves. O(nnz log n) host time, vectorized per level with
    scipy BFS. Separators are ordered LAST (new-to-old: leaves first), so
    the elimination tree is a balanced binary tree — exactly the shape
    the wave schedule wants."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    ip, ix = symmetrize_pattern(indptr, indices, n)
    A = sp.csr_matrix((np.ones(len(ix), np.int8), ix, ip), shape=(n, n))
    out = np.empty(n, dtype=np.int64)
    pos_hi = n  # separators fill from the back

    # iterative recursion over (vertex set) pieces
    stack = [np.arange(n, dtype=np.int64)]
    leaves = []
    while stack:
        vs = stack.pop()
        if len(vs) <= leaf:
            leaves.append(vs)
            continue
        Asub = A[vs][:, vs]
        nsub = len(vs)
        # pseudo-peripheral start: BFS from any vertex, restart from the
        # farthest vertex once
        lvl0 = csgraph.breadth_first_order(Asub, 0, directed=False,
                                           return_predecessors=False)
        start = int(lvl0[-1])
        order_, pred = csgraph.breadth_first_order(
            Asub, start, directed=False, return_predecessors=True)
        if len(order_) < nsub:
            # disconnected: split by component, no separator needed
            ncomp, labels = csgraph.connected_components(Asub,
                                                         directed=False)
            for c in range(ncomp):
                stack.append(vs[labels == c])
            continue
        # BFS depth per vertex
        depth = np.zeros(nsub, np.int64)
        for v in order_[1:]:
            depth[v] = depth[pred[v]] + 1
        # split at the median level
        med = int(np.median(depth))
        half = depth <= med
        # separator: vertices of the near half adjacent to the far half
        far = ~half
        far_idx = np.flatnonzero(far)
        touch = Asub[far_idx].indices  # neighbors of far vertices (local ids)
        sep_mask = np.zeros(nsub, bool)
        sep_mask[touch] = True
        sep_mask &= half
        a_mask = half & ~sep_mask
        sep = vs[sep_mask]
        if not len(sep) or not a_mask.any() or not far.any():
            leaves.append(vs)   # degenerate split: treat as leaf
            continue
        pos_hi -= len(sep)
        out[pos_hi: pos_hi + len(sep)] = sep
        stack.append(vs[a_mask])
        stack.append(vs[far_idx])

    # AMD each leaf for local fill reduction
    pos = 0
    for vs in leaves:
        if len(vs) > 2:
            Asub = sp.csr_matrix(A[vs][:, vs])
            sub_perm = amd_order(Asub.indptr.astype(np.int64),
                                 Asub.indices.astype(np.int64), len(vs))
            vs = vs[sub_perm]
        out[pos: pos + len(vs)] = vs
        pos += len(vs)
    assert pos == pos_hi, (pos, pos_hi)
    return out
