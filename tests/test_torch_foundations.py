"""Port foundations against the JAX package: partitions, hashes, backend,
and the import boundary (the port never imports JAX or hpclinalg).

Partitions and hashes are host numpy in both packages and must agree bit
for bit: the hashes key every plan cache."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.partition as jpart
import hpclinalg_torch as ht
import hpclinalg_torch.partition as tpart

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.eye(k)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


@pytest.mark.parametrize("S", [1, 4, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 100, 1001])
def test_partitions_equal(S, n):
    pj, pt = jpart.uniform_partition(n, S), tpart.uniform_partition(n, S)
    assert np.array_equal(pj, pt) and pj.dtype == pt.dtype
    assert jpart.padded_size(pj) == tpart.padded_size(pt)
    assert np.array_equal(jpart.shard_mask(pj), tpart.shard_mask(pt))
    ids = np.arange(n)
    assert np.array_equal(jpart.owner_of(pj, ids), tpart.owner_of(pt, ids))
    oj, lj = jpart.global_to_local(pj, ids)
    ot, lt = tpart.global_to_local(pt, ids)
    assert np.array_equal(oj, ot) and np.array_equal(lj, lt)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_partition_hash_equal(S):
    for n in (0, 13, 400):
        p = tpart.uniform_partition(n, S)
        assert ht.partition_hash(p) == hl.partition_hash(p)
    uneven = np.array([0, 0, 5, 5, 12] + [12] * (S - 4)) if S >= 4 else \
        np.array([0, 12])
    assert ht.partition_hash(uneven) == hl.partition_hash(uneven)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_sparse_structural_hash_equal(S):
    rng = np.random.default_rng(S)
    for A in (laplace2d(9), sp.random(70, 90, 0.05, format="csr",
                                      random_state=rng)):
        Aj = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=S))
        At = ht.DistSparseMatrix.from_scipy(
            A, ht.backend_auto(S, device="cpu"))
        assert At.hash == Aj.hash
        st = At.structure
        assert ht.sparse_structural_hash(
            st.row_partition, st.col_partition, st.indptr, st.col_indices,
            st.colval) == hl.sparse_structural_hash(
            st.row_partition, st.col_partition, st.indptr, st.col_indices,
            st.colval)


def test_backend_identity():
    a = ht.Backend("cpu", 4)
    b = ht.Backend(torch.device("cpu"), 4, dtype=torch.float64)
    assert a.key == b.key and a.complex_capable
    assert a.dtype == np.float64 and a.index_dtype == np.int32
    assert ht.Backend("cpu", 2).key != a.key
    assert ht.Backend("meta", 4).key != a.key, "the key must name the device"
    with pytest.raises(ValueError):
        ht.Backend("cpu", 0)


def test_backend_auto_never_falls_back_to_the_cpu(monkeypatch):
    """With no CUDA device, backend_auto() raises; the CPU is taken only
    when the caller names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.backend_auto()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.backend_auto(4, dtype=np.float32)
    be = ht.backend_auto(device="cpu")
    assert be.device == torch.device("cpu") and be.nshards == 1
    assert ht.backend_auto(4, device=torch.device("cpu")).nshards == 4


def test_cache_registry():
    from hpclinalg_torch.cache import cached_plan, plan_cache

    ht.clear_plan_cache("t_probe")
    built = []
    for _ in range(3):
        cached_plan("t_probe", ("k",), lambda: built.append(1) or "plan")
    assert built == [1] and ht.cache_sizes()["t_probe"] == 1
    assert plan_cache("t_probe") is plan_cache("t_probe")
    ht.clear_plan_cache("t_probe")
    assert ht.cache_sizes()["t_probe"] == 0


def test_import_without_jax():
    """The port's import graph holds neither JAX nor the JAX package:
    every module under hpclinalg_torch/, found by walking the package."""
    code = ("import importlib, pkgutil, sys, hpclinalg_torch; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "hpclinalg_torch.__path__, 'hpclinalg_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert len(mods) > 40, mods; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'hpclinalg' or "
            "m.startswith('hpclinalg.')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_native_library_names():
    """The port builds the shared C++ sources under its own names, apart
    from the JAX package's native/libhpc*.so."""
    from hpclinalg_torch.solver import native

    lib = native.load_sym()
    assert lib is not None
    path = lib._name
    assert os.path.dirname(path) == native.build_dir()
    assert os.path.basename(path).startswith("libhpctorch_")
    assert not os.path.abspath(path).startswith(
        os.path.join(REPO, "native") + os.sep)
