"""Complex values through the port (native complex64 / complex128) against
both forms of complex in the JAX package.

* The split-plane facade (hpclinalg/cplx.py: ``ComplexDistVector``,
  ``ComplexDistSparseMatrix``, ``lu_complex``, ``ldlt_complex``,
  ``ComplexFactorization``) in c64 from f32 planes at S = 2, as
  tests/test_cplx.py builds it, against the port's native complex64 at
  S = 2 ("planes").
* Native complex128 at S = 4, conftest's ``c128-4shards`` ("native").

The scenarios are tests/test_cplx.py's and tests/test_complexify.py's:
vector round trip and arithmetic; the sparse operators; device LU and
LDLᵀ with the transposed solve, the multi-RHS solve and ``refactorize`` at
1, 2 and 4 shards; the host engine, ``solve_matrix`` and the backslash
cache; mixed real/complex operations. The JAX package's ``realify_*``
(its complex-incapable runtime's 2n real form) and its realified
``ComplexDeviceFactorization`` (with its refusal of an unsymmetric LDLᵀ
input) have no counterpart in the port, so those checks are not carried
over. Tolerances: rtol 1e-12 of
the largest |value| in c128; in c64 rtol 1e-5 for products and sums (f32
parts summed in other orders) and test_cplx.py's residual bounds for
solves.

Then the kernels' layout in the complex item size (the engine choice, K2's
units and lanes, K1's window, K3's staging), ``ell_operands`` taking
complex, the complex plain versions of K1, K2 (tail included) and K3 held
to ``complex_products`` over the real plain versions, and
``from_reference`` carrying the split-plane containers over.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.ops.spmv as jspmv
from hpclinalg.cplx import (ComplexDistSparseMatrix, ComplexDistVector,
                            ComplexFactorization, ldlt_complex, lu_complex)
import hpclinalg_torch as ht
import hpclinalg_torch.ops.spmv as tspmv
from hpclinalg_torch.ops import cuda_dia as k1
from hpclinalg_torch.ops import cuda_ell as k2
from hpclinalg_torch.ops import cuda_ell_resident as k3
from hpclinalg_torch.solver import device_mf
from hpclinalg_torch.tools.matrices import (banded_design, complex_values,
                                            helmholtz)
from hpclinalg_torch.utils.convert import from_reference

torch.set_num_threads(1)

FORMS = {"planes": (2, np.complex64), "native": (4, np.complex128)}
RTOL = {np.complex64: 1e-5, np.complex128: 1e-12}
RES = {np.complex64: 1e-4, np.complex128: 1e-10}   # residual bounds
H100_CAP = 232448


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max(
                                   initial=0.0))))


def _rng(seed=7):
    return np.random.default_rng(seed)


def _cvec(rng, n, dt=np.complex128):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dt)


def _rand_complex_csr(n=120, density=0.06, seed=3, dt=np.complex64):
    """tests/test_cplx.py's matrix."""
    Ar = sp.random(n, n, density, random_state=seed, format="csr")
    Ai = sp.random(n, n, density, random_state=seed + 1, format="csr")
    A = (Ar + 1j * Ai + sp.eye(n)).tocsr().astype(dt)
    A.sort_indices()
    return A


def _res(A, x, b):
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


class Pair:
    """One form: the JAX backend and containers, the port's, on the same
    shard count. ``dt`` is the complex type both hold."""

    def __init__(self, form):
        self.form = form
        self.S, self.dt = FORMS[form]
        self.rtol = RTOL[self.dt]
        if form == "planes":
            self.jbe = hl.backend_auto(nshards=self.S, dtype=np.float32)
        else:
            self.jbe = hl.backend_auto(nshards=self.S, dtype=np.complex128)
        self.tbe = ht.backend_auto(self.S, dtype=self.dt, device="cpu")

    def vec(self, z, partition=None):
        p = None if partition is None else np.asarray(partition)
        if self.form == "planes":
            zj = ComplexDistVector.from_global(z, self.jbe, partition=p)
        else:
            zj = hl.DistVector.from_global(z, self.jbe, partition=p)
        return zj, ht.DistVector.from_global(z, self.tbe, partition=p)

    def mat(self, A):
        if self.form == "planes":
            Aj = ComplexDistSparseMatrix.from_scipy(A, self.jbe)
        else:
            Aj = hl.DistSparseMatrix.from_scipy(A, self.jbe)
        return Aj, ht.DistSparseMatrix.from_scipy(A, self.tbe)

    def real_vec(self, v):
        dt = np.float32 if self.form == "planes" else np.float64
        return (hl.DistVector.from_global(v, self.jbe, dtype=dt),
                ht.DistVector.from_global(v, self.tbe, dtype=dt))

    def real_mat(self, R):
        dt = np.float32 if self.form == "planes" else np.float64
        return (hl.DistSparseMatrix.from_scipy(R, self.jbe, dtype=dt),
                ht.DistSparseMatrix.from_scipy(R, self.tbe, dtype=dt))


def _np(x):
    """numpy of a container or a scalar of either package."""
    if hasattr(x, "to_numpy"):
        return np.asarray(x.to_numpy())
    if hasattr(x, "to_scipy"):
        return x.to_scipy().toarray()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _dense(M):
    return M.to_scipy().toarray()


@pytest.fixture(params=list(FORMS))
def pair(request):
    return Pair(request.param)


# -- vectors -------------------------------------------------------------------

def test_vector_roundtrip_and_arith(pair):
    rng = _rng()
    z, w = _cvec(rng, 95, pair.dt), _cvec(rng, 95, pair.dt)
    zj, zt = pair.vec(z)
    wj, wt = pair.vec(w)
    assert zt.dtype == torch.from_numpy(z).dtype
    np.testing.assert_array_equal(zt.to_numpy(), z)
    np.testing.assert_array_equal(_np(zj).astype(pair.dt), z)
    c = 1.5 - 2.25j
    for name, fj, ft, ref in (
            ("add", zj + wj, zt + wt, z + w),
            ("sub", zj - wj, zt - wt, z - w),
            ("mul", zj * wj, zt * wt, z * w),
            ("scale", zj * c, zt * c, z * c),
            ("div", zj / c, zt / c, z / c),
            ("conj", zj.conj(), zt.conj(), np.conj(z)),
            ("abs", zj.abs(), zt.abs(), np.abs(z))):
        _close(_np(ft), _np(fj), pair.rtol)
        _close(_np(ft), ref, pair.rtol)
    # the conjugating dot of the reference (vectors.jl:798), norm, sum
    for fj, ft, ref in ((zj.dot(wj), zt.dot(wt), np.vdot(z, w)),
                        (zj.norm(), zt.norm(), np.linalg.norm(z)),
                        (zj.sum(), zt.sum(), z.sum())):
        _close(complex(ft), complex(fj), pair.rtol)
        _close(complex(ft), ref, pair.rtol)
    p = np.array([0, 10, 95]) if pair.S == 2 else np.array([0, 10, 40, 40, 95])
    zr = ht.repartition(zt, p)
    np.testing.assert_array_equal(zr.partition, p)
    np.testing.assert_array_equal(zr.to_numpy(), z)
    np.testing.assert_array_equal(_np(zj.repartition(p)).astype(pair.dt), z)


# -- sparse operators ------------------------------------------------------------

def test_sparse_operators(pair):
    rng = _rng()
    A = _rand_complex_csr(dt=pair.dt)
    B = _rand_complex_csr(seed=9, dt=pair.dt)
    n = A.shape[0]
    Aj, At = pair.mat(A)
    Bj, Bt = pair.mat(B)
    assert At.dtype == torch.from_numpy(A.data).dtype and At.nnz() == A.nnz
    assert At.hash == Aj.hash
    np.testing.assert_array_equal(_dense(At), A.toarray())
    z = _cvec(rng, n, pair.dt)
    zj, zt = pair.vec(z)
    _close(_np(At @ zt), _np(Aj @ zj), pair.rtol)
    _close(_np(At @ zt), A @ z, pair.rtol)
    c, lam = 0.5 + 2j, 0.3 - 0.7j
    for name, fj, ft, ref in (
            ("add", Aj + Bj, At + Bt, A + B),
            ("sub", Aj - Bj, At - Bt, A - B),
            ("scale", Aj * c, At * c, A * c),
            ("neg", -Aj, -At, -A),
            ("T", Aj.T.materialize(), At.T.materialize(), A.T),
            ("H", Aj.H.materialize(), At.H.materialize(), A.conj().T),
            ("spgemm", Aj @ Bj, At @ Bt, A @ B),
            ("add_identity", Aj.add_identity(lam), At.add_identity(lam),
             A + lam * sp.eye(n))):
        _close(_dense(ft), _dense(fj), pair.rtol)
        _close(_dense(ft), sp.csr_matrix(ref).toarray(), pair.rtol)
    # the lazy transposes multiply without materializing
    _close(_np(At.T @ zt), A.T @ z, pair.rtol)
    _close(_np(At.H @ zt), A.conj().T @ z, pair.rtol)
    # norms and reductions
    Ad = A.toarray()
    absd = np.abs(A.data)
    for fj, ft, ref in (
            (Aj.norm(), At.norm(), np.sqrt((absd ** 2).sum())),
            (Aj.norm(1), At.norm(1), absd.sum()),
            (Aj.opnorm(np.inf), At.opnorm(np.inf),
             np.abs(Ad).sum(axis=1).max()),
            (Aj.opnorm(1), At.opnorm(1), np.abs(Ad).sum(axis=0).max()),
            (Aj.tr(), At.tr(), A.diagonal().sum()),
            (Aj.sum(), At.sum(), A.sum())):
        _close(complex(_np(ft)), complex(_np(fj)), pair.rtol)
        _close(complex(_np(ft)), complex(ref), pair.rtol)
    for axis in (0, 1):
        got = _np(At.sum(axis=axis)).reshape(-1)
        _close(got, _np(Aj.sum(axis=axis)).reshape(-1), pair.rtol)
        _close(got, np.asarray(A.sum(axis=axis)).reshape(-1), pair.rtol)
    _close(_np(At.diag()), _np(Aj.diag()), pair.rtol)
    _close(_np(At.diag()), A.diagonal(), pair.rtol)


def test_mixed_real_complex(pair):
    rng = _rng()
    A = _rand_complex_csr(n=80, dt=pair.dt)
    rdt = np.float32 if pair.form == "planes" else np.float64
    R = (sp.random(80, 80, 0.06, random_state=11, format="csr")
         + sp.eye(80, format="csr")).astype(rdt)
    v = rng.standard_normal(80).astype(rdt)
    Aj, At = pair.mat(A)
    Rj, Rt = pair.real_mat(R)
    vj, vt = pair.real_vec(v)
    assert Rt.dtype == torch.from_numpy(R.data).dtype
    for fj, ft, ref in ((Aj @ vj, At @ vt, A @ v),
                        (Aj + Rj, At + Rt, A + R),
                        (Aj @ Rj, At @ Rt, A @ R)):
        _close(_np(ft) if hasattr(ft, "to_numpy") else _dense(ft),
               _np(fj) if hasattr(fj, "to_numpy") else _dense(fj),
               pair.rtol)
        got = _np(ft) if hasattr(ft, "to_numpy") else _dense(ft)
        _close(got, ref.toarray() if sp.issparse(ref) else ref, pair.rtol)
    # a real matrix times a complex vector: the port widens the real one
    z = _cvec(rng, 80, pair.dt)
    _, zt = pair.vec(z)
    _close(_np(Rt @ zt), R @ z, pair.rtol)


# -- solvers -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_device_solutions():
    """The JAX package's device LU and LDLᵀ solutions on Helmholtz(12) in
    both forms (each a compile of the JAX device engine): the facade's
    lu_complex / ldlt_complex at S = 2 from f32 planes, and the native
    c128 engine at S = 4. Keyed by (form, kind): (x, transposed x or
    None)."""
    A = helmholtz(12)
    z = _cvec(_rng(5), A.shape[0])
    out = {}
    be2 = hl.backend_auto(nshards=2, dtype=np.float32)
    A64 = A.astype(np.complex64)
    Ad = ComplexDistSparseMatrix.from_scipy(A64, be2)
    zd = ComplexDistVector.from_global(z.astype(np.complex64), be2)
    F = lu_complex(Ad, method="device")
    out["planes", "lu"] = (F.solve(zd).to_numpy(),
                           F.solve(zd, transpose=True).to_numpy())
    out["planes", "ldl"] = (ldlt_complex(Ad, method="device").solve(zd)
                            .to_numpy(), None)
    be4 = hl.backend_auto(nshards=4, dtype=np.complex128)
    Aj = hl.DistSparseMatrix.from_scipy(A, be4)
    zj = hl.DistVector.from_global(z, be4)
    F = hl.lu(Aj, method="device")
    out["native", "lu"] = (np.asarray(F.solve(zj).to_numpy()),
                           np.asarray(F.solve(zj, transpose=True).to_numpy()))
    out["native", "ldl"] = (np.asarray(hl.ldlt(Aj, method="device")
                                       .solve(zj).to_numpy()), None)
    return A, z, out


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_device_lu_ldlt(S, form, jax_device_solutions):
    """test_complexify.py's device LU and LDLᵀ at 1, 2 and 4 shards: solve,
    transposed solve, multi-RHS, refactorize with new values; each against
    scipy's residual and the JAX package's solution in the same form."""
    A, z, jsol = jax_device_solutions
    dt = FORMS[form][1]
    n = A.shape[0]
    Ar, zr = A.astype(dt), z.astype(dt)
    be = ht.backend_auto(S, dtype=dt, device="cpu")
    Ad = ht.DistSparseMatrix.from_scipy(Ar, be)
    zd = ht.DistVector.from_global(zr, be)
    tol = RES[dt]
    F = ht.lu(Ad, method="device")
    assert isinstance(F, device_mf.DeviceFactorization)
    x, xt = F.solve(zd).to_numpy(), F.solve(zd, transpose=True).to_numpy()
    assert _res(Ar, x, zr) < tol and _res(Ar.T, xt, zr) < tol
    jx, jxt = jsol[form, "lu"]
    _close(x, jx, 10 * tol)
    _close(xt, jxt, 10 * tol)
    B = np.stack([_cvec(_rng(6 + k), n, dt) for k in range(3)], axis=1)
    X = F.solve_matrix(B)
    assert _res(Ar, np.asarray(X), B) < tol
    A2 = helmholtz(12, shift=0.3, damp=0.07).astype(dt)
    F.refactorize(ht.DistSparseMatrix.from_scipy(A2, be))
    assert _res(A2, F.solve(zd).to_numpy(), zr) < tol
    L = ht.ldlt(Ad, method="device")
    assert isinstance(L, device_mf.DeviceFactorization)
    assert L.factors[0][0][0].dtype == torch.from_numpy(zr).dtype
    xl = L.solve(zd).to_numpy()
    assert _res(Ar, xl, zr) < tol
    _close(xl, jsol[form, "ldl"][0], 10 * tol)


def test_host_engine_and_backslash(pair):
    """test_cplx.py's host engine, solve_matrix and backslash cache."""
    rng = _rng()
    A = _rand_complex_csr(n=100, dt=pair.dt)
    n = A.shape[0]
    z = _cvec(rng, n, pair.dt)
    Aj, At = pair.mat(A)
    zj, zt = pair.vec(z)
    tol = RES[pair.dt]
    if pair.form == "planes":
        Fj = ComplexFactorization(Aj, kind="lu", method="host")
    else:
        Fj = hl.lu(Aj, method="host")
    xj = _np(Fj.solve(zj))
    F = ht.lu(At)
    assert F.native is not None
    x = F.solve(zt).to_numpy()
    assert _res(A, x, z) < tol
    _close(x, xj, 10 * tol)
    B = np.stack([_cvec(rng, n, pair.dt) for _ in range(3)], axis=1)
    X = np.asarray(F.solve_matrix(B))
    assert _res(A, X, B) < 10 * tol
    ht.clear_plan_cache("backslash")
    x3 = ht.solve(At, zt).to_numpy()
    assert _res(A, x3, z) < tol
    cache = ht.BackslashCache._cache()
    F1 = next(iter(cache.values()))
    # same pattern, new values: a refactorize-only hit
    A2 = (A * (1.0 + 0.5j)).tocsr().astype(pair.dt)
    At2 = At.with_values(ht.DistSparseMatrix.from_scipy(A2, pair.tbe).nzval)
    x4 = ht.solve(At2, zt).to_numpy()
    assert len(cache) == 1 and next(iter(cache.values())) is F1
    assert F1.A is At2 and _res(A2, x4, z) < tol
    xj4 = _np(hl.solve(pair.mat(A2)[0], zj))
    _close(x4, xj4, 10 * tol)
    ht.clear_plan_cache("backslash")


# -- carrying state over ---------------------------------------------------------

def test_from_reference_split_planes():
    """A split-plane ComplexDistVector / ComplexDistSparseMatrix becomes one
    native complex64 container equal to the port's own, structure, hash
    and values bit for bit; so does a native c128 JAX container."""
    rng = _rng()
    for form in FORMS:
        pr = Pair(form)
        A = _rand_complex_csr(dt=pr.dt)
        z = _cvec(rng, A.shape[0], pr.dt)
        Aj, At = pr.mat(A)
        zj, zt = pr.vec(z)
        Mc = from_reference(pr.tbe, Aj)
        vc = from_reference(pr.tbe, zj)
        assert isinstance(Mc, ht.DistSparseMatrix)
        assert isinstance(vc, ht.DistVector)
        assert Mc.dtype == At.dtype and vc.dtype == zt.dtype
        assert Mc.hash == At.hash == Aj.hash
        st, sr = Mc.structure, At.structure
        for a in ("indptr", "colval", "col_indices"):
            for x, y in zip(getattr(st, a), getattr(sr, a)):
                np.testing.assert_array_equal(x, y)
        assert torch.equal(Mc.nzval, At.nzval)
        assert torch.equal(vc.data, zt.data)
        np.testing.assert_array_equal(vc.partition, zt.partition)
        _close((Mc @ vc).to_numpy(), A @ z, pr.rtol)


# -- the kernels' layout in the complex item size ----------------------------

@pytest.fixture(scope="module")
def normal_pattern():
    """The ridge path's normal matrix N = AᵀA + λI at its 16,384 columns
    (a 60,000-row design: fewer rows, the same column space), with seeded
    complex values."""
    A, _ = banded_design(60_000, 16_384, 8)
    N = (A.T @ A + 1e-2 * sp.eye(16_384)).tocsr()
    return complex_values(N, 9)


def test_engine_choice_complex(normal_pattern, monkeypatch):
    """The resident engine needs the gathered x in the product's dtype to
    fit the H100's cap: 16,392 slots are 131 KB in c64 (K3) and 262 KB in
    c128 (K2); four shards gather about a quarter each (K3)."""
    monkeypatch.setattr(tspmv, "MIN_NNZ", 0)
    N = normal_pattern
    c64, c128 = torch.complex64, torch.complex128
    for S, want in ((1, {c64: "resident", c128: "ell"}),
                    (4, {c64: "resident", c128: "resident"})):
        be = ht.backend_auto(S, dtype=np.complex128, device="cpu")
        Nd = ht.DistSparseMatrix.from_scipy(N, be)
        x = ht.DistVector.from_global(np.ones(N.shape[1]), be)
        plan = tspmv.get_spmv_plan(Nd, x)
        G = plan.exchange.out_pad
        assert plan.resident_cap == H100_CAP
        for dt, eng in want.items():
            assert plan.engine(dt) == eng, (S, dt, G)
            assert (G * dt.itemsize <= H100_CAP) == (eng == "resident")
            lanes, win = plan.ell_layout(dt)
            assert lanes == k2.lanes_for(plan.ell_W, plan.ell_mean_len,
                                         dt.itemsize)
            assert (win is not None) == (eng == "resident")
            if win is not None:
                assert win.staged in (0, win.width)
                assert (win.staged > 0) == (2 * win.width * dt.itemsize
                                            <= H100_CAP)
        _close((Nd @ ht.DistVector.from_global(
            np.arange(N.shape[1]) * (1 - 1j), be)).to_numpy(),
            N @ (np.arange(N.shape[1]) * (1 - 1j)), 1e-12)


@pytest.mark.parametrize("itemsize,unit", [(4, 4), (8, 2), (16, 1)])
def test_units_and_lanes(itemsize, unit):
    """16 bytes of values a load: 4 f32, 2 f64 or c64 entries, 1 c128."""
    for W in (4, 8, 12, 16, 20):
        want = unit if W % unit == 0 else 1
        assert k2.unit_entries(W, itemsize) == want
    assert k2.unit_entries(7, itemsize) == 1
    # lanes cover sqrt(mean * W) entries in units of unit_entries
    for W, mean in ((8, 8.0), (20, 6.0), (64, 3.0)):
        u = k2.unit_entries(W, itemsize)
        need = int(np.ceil(np.sqrt(mean * W) / u))
        lanes = k2.lanes_for(W, mean, itemsize)
        assert lanes in (1, 2, 4, 8, 16, 32)
        assert lanes >= min(need, 32) and (lanes == 1 or lanes // 2 < need)
    assert k2.lanes_for(8, 8.0, 16) == 2 * k2.lanes_for(8, 8.0, 8)


@pytest.mark.parametrize("esize", [8, 16])
def test_dia_layout_complex_entries(esize):
    """K1's window in 16-byte entries: a tile is threads · 16 / esize rows
    (256 rows a block in c128), pieces start and end on whole 16-byte
    units, and the window covers every diagonal's rows."""
    offsets = (-1000, -1, 0, 1, 1000)
    lay = k1.dia_layout(offsets, esize, H100_CAP)
    V = 16 // esize
    assert lay.tile == lay.threads * V
    assert lay.smem_bytes == sum(p[1] for p in lay.pieces) * esize
    assert lay.smem_bytes <= H100_CAP
    for lo, length, base in lay.pieces:
        assert lo % V == 0 and length % V == 0 and base % V == 0
    for t, o in enumerate(offsets):
        piece = [p for p in lay.pieces
                 if p[2] <= lay.shifts[t] < p[2] + p[1]][0]
        lo, length, base = piece
        # tile row r reads window slot shifts[t] + r = base + (o + r - lo)
        assert lay.shifts[t] == base + o - lo
        assert o >= lo and o + lay.tile <= lo + length
    # a window too wide for 256 threads in c128 takes fewer
    wide = tuple(range(0, 64 * 300, 300))
    lay16 = k1.dia_layout(wide, 16, 64 * 1024)
    assert lay16.smem_bytes <= 64 * 1024 and lay16.threads < 256


def test_make_windows_complex_item_size():
    """K3 stages two windows when they fit the cap in the item size: a
    window of 8,000 slots fits twice in c64 (128 KB) and not in c128
    (256 KB), where the kernel stages the whole x instead."""
    S, Lrow, W = 1, 512, 4
    rng = _rng(3)
    cols = rng.integers(0, 8_000, (S, Lrow, W)).astype(np.int32)
    cols[0, 0, 0], cols[0, 0, 1] = 0, 7_999
    rowlen = np.full((S, Lrow), W, np.int32)
    cpu = torch.device("cpu")
    w64 = k3.make_windows(cols, rowlen, 4, torch.complex64, cpu)
    w128 = k3.make_windows(cols, rowlen, 4, torch.complex128, cpu)
    assert w64.width == w128.width >= 8_000
    assert w64.staged == w64.width and w128.staged == 0
    assert 2 * w64.width * 8 <= H100_CAP < 2 * w128.width * 16


@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
def test_ell_operands_take_complex(dt):
    """ell_operands (checked=True: the plan's tables) takes complex values
    and x, casts a real operand to the product's complex type and gives
    the 16-byte unit in entries; other types still raise."""
    S, Lrow, W = 2, 16, 4
    rng = _rng(4)
    vals = torch.from_numpy(_cvec(rng, S * Lrow * W)
                            .reshape(S, Lrow, W)).to(dt)
    cols = torch.from_numpy(rng.integers(0, 32, (S, Lrow * W))
                            .astype(np.int32))
    rowlen = torch.full((S, Lrow), W, dtype=torch.int32)
    g = torch.from_numpy(_cvec(rng, S * 32).reshape(S, 32)).to(dt)
    out = k2.ell_operands("ell_spmv", vals, cols, g, None, rowlen, 2,
                          checked=True)
    assert out[0] == dt and out[1].dtype == dt and out[2].dtype == dt
    assert out[4] in (1, k2.unit_entries(W, dt.itemsize))
    real = torch.float32 if dt == torch.complex64 else torch.float64
    mixed = k2.ell_operands("ell_spmv", vals.real.to(real).contiguous(),
                            cols, g, None, rowlen, 2, checked=True)
    assert mixed[0] == dt and mixed[1].dtype == dt
    with pytest.raises(TypeError):
        k2.ell_operands("ell_spmv", vals.real.half(), cols, g.real.half(),
                        None, rowlen, 2, checked=True)


def test_dia_kernel_choice_complex():
    """c128 takes dia_vec a row an access (a row is a whole 16-byte unit);
    c64 takes dia_vec two rows an access, dia_scalar when unaligned."""
    d = torch.zeros((2, 3, 256), dtype=torch.complex128)
    g = torch.zeros((2, 300), dtype=torch.complex128)
    y = torch.zeros((2, 256), dtype=torch.complex128)
    assert k1.dia_kernel(d, g, y) == "dia_vec"
    assert k1.dia_vector_width(d, g, y) == 1
    d64, g64, y64 = (t.to(torch.complex64) for t in (d, g, y))
    assert k1.dia_kernel(d64, g64, y64) == "dia_vec"
    assert k1.dia_vector_width(d64, g64, y64) == 2
    flat = torch.zeros(2 * 300 + 1, dtype=torch.complex64)
    assert k1.dia_kernel(d64, flat[1:].view(2, 300), y64) == "dia_scalar"
    assert k1.dia_kernel(torch.zeros((2, 3, 255), dtype=torch.complex64),
                         g64, y64) == "dia_scalar"


# -- the complex plain versions ----------------------------------------------------

@pytest.mark.parametrize("dt,rtol", [(torch.complex64, 1e-5),
                                     (torch.complex128, 1e-12)])
def test_plain_k1_complex(dt, rtol):
    """K1's plain version on complex operands equals complex_products over
    the real plain version, for a complex table and x, and for a real table
    (a real stencil) times a complex x; the CPU model of the kernels' walk
    (the window, the c128 row an access) equals it bit for bit."""
    rng = _rng(11)
    S, O, Lrow, G = 2, 3, 300, 340
    offsets, bias_lo, bias_hi = (-20, 0, 20), 20, 0
    dval = torch.from_numpy(_cvec(rng, S * O * Lrow).reshape(S, O, Lrow)).to(dt)
    g = torch.from_numpy(_cvec(rng, S * G).reshape(S, G)).to(dt)

    def plain(v, x):
        return k1.dia_spmv_plain(v, x, offsets, bias_lo, bias_hi)
    want = plain(dval, g)
    assert want.dtype == dt
    _close(k1.complex_products(plain, dval, g).numpy(), want.numpy(), rtol)
    real = dval.real.contiguous()
    _close(k1.complex_products(plain, real, g).numpy(),
           plain(real, g).numpy(), rtol)
    model = k1.dia_spmv_split_plain(dval, g, offsets, bias_lo, bias_hi)
    assert torch.equal(model, want)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(k1.dia_spmv(dval, g, offsets, bias_lo, bias_hi), want)


def _ell_case(dt, seed=12):
    rng = _rng(seed)
    S, Lrow, W, G, T = 2, 40, 4, 64, 24
    vals = torch.from_numpy(_cvec(rng, S * Lrow * W).reshape(S, Lrow, W)).to(dt)
    cols = torch.from_numpy(rng.integers(0, G, (S, Lrow * W)).astype(np.int32))
    g = torch.from_numpy(_cvec(rng, S * G).reshape(S, G)).to(dt)
    trows = np.sort(rng.integers(0, Lrow + 1, (S, T)), axis=1).astype(np.int32)
    tv = torch.from_numpy(_cvec(rng, S * T).reshape(S, T)).to(dt)
    tg = torch.from_numpy(rng.integers(0, G, (S, T)).astype(np.int32))
    return vals, cols, g, (tv, torch.from_numpy(trows), tg)


@pytest.mark.parametrize("dt,rtol", [(torch.complex64, 1e-5),
                                     (torch.complex128, 1e-12)])
@pytest.mark.parametrize("with_tail", [False, True])
def test_plain_k2_k3_complex(dt, rtol, with_tail):
    """K2's plain version (its COO tail included) and K3's (K2's function)
    on complex operands equal complex_products over the real plain
    version: the table and the tail's values are the matrix, x the other
    factor."""
    vals, cols, g, tail = _ell_case(dt)
    S, Lrow, W = vals.shape
    tail = tail if with_tail else None
    want = k2.ell_spmv_plain(vals, cols, g, tail)
    assert want.dtype == dt
    packed = vals.reshape(S, -1)
    if tail is not None:
        packed = torch.cat([packed, tail[0]], dim=1)

    def plain(m, x):
        v = m[:, : Lrow * W].reshape(S, Lrow, W)
        t = (m[:, Lrow * W:], tail[1], tail[2]) if tail is not None else None
        return k2.ell_spmv_plain(v, cols, x, t)
    _close(k1.complex_products(plain, packed, g).numpy(), want.numpy(), rtol)
    assert torch.equal(k3.ell_resident_spmv_plain(vals, cols, g, tail), want)
    # the wrappers on CPU tensors are the plain versions
    assert torch.equal(k2.ell_spmv(vals, cols, g, tail), want)
    assert torch.equal(k3.ell_resident_spmv(vals, cols, g, tail), want)


@pytest.mark.parametrize("dt,rtol", [(torch.complex64, 1e-5),
                                     (torch.complex128, 1e-12)])
def test_tail_segmented_plain_complex(dt, rtol):
    """The tail summed the way the kernel sums it (a run of a row inside a
    thread, a warp's last runs merged, one atomic add of each component a
    segment) equals the plain scatter-add in complex."""
    rng = _rng(13)
    S, Lrow, T, G = 2, 50, 8 * 40, 64
    trows = np.sort(np.minimum(rng.zipf(1.5, (S, T)) - 1, Lrow),
                    axis=1).astype(np.int32)
    tv = torch.from_numpy(_cvec(rng, S * T).reshape(S, T)).to(dt)
    tg = torch.from_numpy(rng.integers(0, G, (S, T)).astype(np.int32))
    g = torch.from_numpy(_cvec(rng, S * G).reshape(S, G)).to(dt)
    y = torch.from_numpy(_cvec(rng, S * Lrow).reshape(S, Lrow)).to(dt)
    got = k2.ell_tail_segmented_plain(tv, torch.from_numpy(trows), tg, g, y)
    want = torch.cat([y, y.new_zeros((S, 1))], dim=1)
    want.scatter_add_(1, torch.from_numpy(trows).long(),
                      tv * torch.gather(g, 1, tg.long()))
    assert got.dtype == dt
    _close(got.numpy(), want[:, :Lrow].numpy(), rtol)


@pytest.mark.parametrize("S", [1, 4])
def test_ell_engine_complex_matches_jax(S, monkeypatch):
    """The whole product on the ELL engine (densify off in both packages),
    native c128, against the JAX package's _ell_exec: a heavy row spills
    into the COO tail."""
    monkeypatch.setattr(jspmv, "DENSE_MAX_ELEMS", 0)
    monkeypatch.setattr(tspmv, "DENSE_MAX_ELEMS", 0)
    rng = _rng(21)
    n = 300
    A = sp.random(n, n, 0.03, format="lil", random_state=rng)
    A[7, :150] = rng.standard_normal(150)
    A = complex_values(A.tocsr(), 22)
    z = _cvec(rng, n)
    Aj = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(
        nshards=S, dtype=np.complex128))
    zj = hl.DistVector.from_global(z, Aj.backend)
    be = ht.backend_auto(S, dtype=np.complex128, device="cpu")
    At = ht.DistSparseMatrix.from_scipy(A, be)
    zt = ht.DistVector.from_global(z, be)
    plan = tspmv.get_spmv_plan(At, zt)
    assert plan.engine(torch.complex128) == "ell" and plan.ell_Tpad > 0
    y = (At @ zt).to_numpy()
    _close(y, np.asarray((Aj @ zj).to_numpy()), 1e-12)
    _close(y, A @ z, 1e-12)
