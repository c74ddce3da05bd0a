"""The port's utilities against the JAX package's (tests/test_utilities.py:
io0, the gather roundtrips of all three containers, show and repr, the
plan-cache leak guard), plus to_backend, backend_serial, comm_rank /
comm_size, clear_solver_caches, profile_trace / annotate, warmup and the
export list.
"""

import io
import json
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from test_torch_indexing import Pair, same_dense, same_sparse, same_vec
from utils import random_sparse

torch.set_num_threads(1)

CONFIGS = [(np.float64, 4), (np.complex128, 4), (np.float32, 8)]


def test_exports_match_the_jax_package():
    """Every name the JAX package exports, but its TPU-only ones."""
    tpu_only = {"AXIS", "enable_x64", "enable_compile_cache",
                "ComplexDistVector", "ComplexDistSparseMatrix",
                "ComplexFactorization"}
    missing = set(hl.__all__) - tpu_only - set(ht.__all__)
    assert not missing, missing
    for name in ht.__all__:
        assert hasattr(ht, name), name


def test_io0_stream_selection():
    buf = io.StringIO()
    assert ht.io0(buf) is buf
    print("test", file=ht.io0(buf), end="")
    assert buf.getvalue() == "test"
    assert ht.io0() is sys.stdout
    sink = ht.io0(buf, ranks={10_000})
    assert sink is not buf
    print("dropped", file=sink)
    assert ht.comm_rank() == 0 == hl.comm_rank()


@pytest.mark.parametrize("T,S", CONFIGS)
def test_roundtrips(T, S):
    be = ht.backend_auto(S, dtype=T, device="cpu")
    v0 = np.linspace(-3, 5, 11).astype(T)
    if np.issubdtype(np.dtype(T), np.complexfloating):
        v0 = v0 + 1j * np.linspace(2, -2, 11)
    back = ht.DistVector.from_global(v0, be, dtype=T).to_numpy()
    np.testing.assert_array_equal(back, v0)
    assert back.dtype == np.dtype(T)
    M0 = np.arange(36.0).reshape(9, 4).astype(T)
    M = ht.DistDenseMatrix.from_global(M0, be, dtype=T)
    np.testing.assert_array_equal(M.to_numpy(), M0)
    assert M.to_numpy().dtype == np.dtype(T) and M.shape == M0.shape
    A0 = sp.random(13, 7, 0.35, random_state=2, format="csr").astype(T)
    A0.sort_indices()
    back = ht.DistSparseMatrix.from_scipy(A0, be, dtype=T).to_scipy()
    assert back.nnz == A0.nnz and back.shape == A0.shape
    assert back.dtype == np.dtype(T) and abs(back - A0).max() == 0


def test_show_and_repr():
    P = Pair(4)
    vj, vt = P.vec(np.array([1.0, 2.0, 3.0, 4.0]))
    r = repr(vt)
    assert "DistVector" in r and "4" in r and "float64" in r
    buf = io.StringIO()
    s = ht.show(vt, stream=buf)
    assert "DistVector" in s and "1." in s
    assert buf.getvalue().startswith("DistVector")
    assert s.splitlines()[1:] == hl.show(vj, stream=io.StringIO()) \
        .splitlines()[1:]
    Mt = ht.DistDenseMatrix.from_global(np.eye(3), P.bt)
    assert "DistDenseMatrix" in repr(Mt) and "float64" in repr(Mt)
    assert "DistDenseMatrix" in ht.show(Mt, stream=io.StringIO())
    E = sp.eye(5, format="csr") * 2.0
    At = ht.DistSparseMatrix.from_scipy(E, P.bt)
    Aj = hl.DistSparseMatrix.from_scipy(E, P.bj)
    assert "DistSparseMatrix" in repr(At) and "shards=4" in repr(At)
    s = ht.show(At, stream=io.StringIO())
    assert "[0, 0]" in s and "2.0" in s
    assert s.splitlines()[1:] == hl.show(Aj, stream=io.StringIO()) \
        .splitlines()[1:]
    assert "more stored entries" in ht.show(At, stream=io.StringIO(),
                                            max_elems=2)
    buf = io.StringIO()
    print(repr(vt), file=ht.io0(buf))
    assert "DistVector" in buf.getvalue()


def test_cache_sizes_and_leak_guard():
    ht.clear_plan_cache()
    assert all(n == 0 for n in ht.cache_sizes().values())
    be = ht.backend_auto(4, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(
        sp.random(30, 30, 0.2, random_state=1, format="csr") + sp.eye(30), be)
    x = ht.DistVector.from_global(np.ones(30), be)
    _ = A @ x
    sizes = ht.cache_sizes()
    assert sum(sizes.values()) >= 1
    ht.check_cache_sizes(max_entries=50)
    with pytest.raises(RuntimeError):
        ht.check_cache_sizes(max_entries=0)
    name = next(k for k, n in sizes.items() if n > 0)
    ht.clear_plan_cache(name)
    assert ht.cache_sizes()[name] == 0
    # two matrices with one pattern share every plan
    ht.clear_plan_cache()
    A0 = (sp.random(24, 24, 0.25, random_state=3, format="csr")
          + sp.eye(24)).tocsr()
    A1 = A0.copy()
    A1.data = A1.data * 2.0
    x = ht.DistVector.from_global(np.ones(24), be)
    _ = ht.DistSparseMatrix.from_scipy(A0, be) @ x
    n_first = sum(ht.cache_sizes().values())
    _ = ht.DistSparseMatrix.from_scipy(A1, be) @ x
    assert sum(ht.cache_sizes().values()) == n_first
    ht.clear_plan_cache()


@pytest.mark.parametrize("S_from,S_to,dtype", [(1, 4, np.float64),
                                               (4, 8, np.float64),
                                               (4, 1, np.float32),
                                               (8, 4, np.complex128)])
def test_to_backend(S_from, S_to, dtype):
    """to_backend moves a container to another shard count and dtype, on
    the target's uniform partition, as the JAX package's does."""
    src = Pair(S_from)
    dst_t = ht.backend_auto(S_to, dtype=dtype, device="cpu")
    dst_j = hl.backend_auto(nshards=S_to, dtype=dtype)
    x = np.random.default_rng(4).standard_normal(19)
    A = random_sparse(19, 13, 0.3, seed=8)
    M = np.random.default_rng(5).standard_normal((19, 3))
    for (cj, ct) in (src.vec(x), src.sparse(A), src.dense(M)):
        got, exp = ht.to_backend(ct, dst_t), hl.to_backend(cj, dst_j)
        assert got.backend is dst_t
        assert got.dtype == ht.backend.torch_dtype(dtype)
        if isinstance(got, ht.DistVector):
            same_vec(got, exp)
        elif isinstance(got, ht.DistSparseMatrix):
            same_sparse(got, exp)
        else:
            same_dense(got, exp)
    with pytest.raises(TypeError):
        ht.to_backend(np.ones(3), dst_t)
    assert ht.comm_size(dst_t) == S_to == hl.comm_size(dst_j)


def test_backend_serial_never_falls_back_to_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ht.backend_serial()
    be = ht.backend_serial(dtype=np.float32, device="cpu")
    assert be.nshards == 1 and be.device == torch.device("cpu")
    assert be.dtype == np.float32 and be.solver == "multifrontal"
    assert ht.backend_serial(device="cpu", solver="device").solver == "device"


def test_clear_solver_caches():
    from hpclinalg_torch.cache import plan_cache

    be = ht.backend_auto(4, device="cpu")
    n = 30
    L = sp.diags([-np.ones(n - 1), 4 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tocsr()
    A = ht.DistSparseMatrix.from_scipy(L, be)
    b = ht.DistVector.from_global(np.ones(n), be)
    ht.solve(A, b)
    plan_cache("device_mf")[("probe",)] = object()
    sizes = ht.cache_sizes()
    assert sizes["backslash"] >= 1 and sizes["symbolic"] >= 1
    plan_cache("spmv_probe")[("probe",)] = object()
    ht.clear_solver_caches()
    sizes = ht.cache_sizes()
    for name in ("symbolic", "solver_perm", "backslash", "device_mf"):
        assert sizes.get(name, 0) == 0, name
    assert sizes["spmv_probe"] == 1     # plans of other kinds stay
    ht.clear_plan_cache("spmv_probe")
    np.testing.assert_allclose(L @ ht.solve(A, b).to_numpy(), np.ones(n),
                               rtol=1e-12)


def test_profile_trace_and_annotate(tmp_path, capsys):
    """profile_trace on the CPU writes a Chrome trace that holds the
    annotated region and reports the plans built inside it."""
    be = ht.backend_auto(2, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(random_sparse(20, 20, 0.3, seed=9), be)
    x = ht.DistVector.from_global(np.ones(20), be)
    ht.clear_plan_cache("vector_plan")
    with ht.profile_trace(str(tmp_path), backend=be):
        with ht.annotate("probe_matvec"):
            y = A @ x
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "probe_matvec" in names
    assert "plans built during trace" in capsys.readouterr().out
    np.testing.assert_allclose(y.to_numpy(),
                               random_sparse(20, 20, 0.3, seed=9) @ np.ones(20),
                               rtol=1e-12)


def test_launch_range_names_kernels_only_while_tracing(tmp_path):
    """The kernel wrappers' launch range: a no-op context with no profiler
    on, and a host range named after the kernel inside profile_trace, so a
    trace names the kernel even where it holds no device activity."""
    import contextlib

    from hpclinalg_torch.ops.cuda_build import launch_range

    assert isinstance(launch_range("ell_rows"), contextlib.nullcontext)
    with ht.profile_trace(str(tmp_path), backend=ht.backend_auto(
            1, device="cpu")):
        with launch_range("ell_rows"):
            pass
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "ell_rows" in names


def test_warmup_on_the_cpu():
    be = ht.backend_auto(4, device="cpu")
    ht.warmup(be)
    assert ht.Symmetric is ht.solver.api.Symmetric


def test_warmup_builds_every_kernel_source():
    """``build_kernels`` (warmup on the card) builds every ``csrc/*.cu``,
    so no first real call runs nvcc."""
    import os

    from hpclinalg_torch.ops.cuda_build import CSRC_DIR
    from hpclinalg_torch.utils.warmup import KERNEL_SOURCES

    sources = {f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")}
    assert sorted(KERNEL_SOURCES) == sorted(sources)


def test_process_rank_under_a_process_group(tmp_path):
    """With a torch.distributed group up, io0 and comm_rank read its rank."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        assert ht.comm_rank() == 0
        assert ht.io0(sys.stdout) is sys.stdout
        assert ht.io0(sys.stdout, ranks={1}) is not sys.stdout
    finally:
        dist.destroy_process_group()
    assert ht.comm_rank() == 0
