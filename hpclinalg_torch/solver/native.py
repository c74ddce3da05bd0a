"""ctypes bridge to the native host engines (native/*.cpp).

The C++ sources are shared with the JAX package and read unchanged; this
module compiles them under its own library names into the git-ignored
``build/native/<host>/`` directory at the repository root, so the two
packages never rebuild the same shared object concurrently. ``<host>`` is a
digest of the CPU's feature flags: the libraries are built with
``-march=native`` and must not be loaded on another kind of CPU. BLAS is
resolved at run time from scipy's bundled OpenBLAS.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
from functools import lru_cache

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_REPO, "native")

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C")


@lru_cache(maxsize=1)
def build_dir() -> str:
    """build/native/<digest of this CPU's architecture and feature flags>."""
    import hashlib
    import platform

    txt = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    txt += line
                    break
    except OSError:
        pass
    tag = hashlib.blake2b(txt.encode(), digest_size=6).hexdigest()
    return os.path.join(_REPO, "build", "native", tag)


def build_native_lib(name: str, src_name: str, extra: tuple = ()):
    """Compile native/<src_name> into build_dir()/lib<name>.so if stale and
    return a CDLL, or None when the source is missing or g++ fails. The
    object is written under a per-process temporary name and renamed into
    place, so concurrent test workers never load a half-written file."""
    so = os.path.join(build_dir(), f"lib{name}.so")
    src = os.path.join(_NATIVE_DIR, src_name)
    if not os.path.exists(src):
        return None
    if (not os.path.exists(so)) or os.path.getmtime(src) > os.path.getmtime(so):
        os.makedirs(build_dir(), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            "-o", tmp, src, *extra],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        os.replace(tmp, so)
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None


@lru_cache(maxsize=1)
def load_sym():
    """Symbolic-analysis kernels (native/sym.cpp)."""
    lib = build_native_lib("hpctorch_sym", "sym.cpp")
    if lib is None:
        return None
    lib.sym_etree.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
    lib.sym_etree.restype = ctypes.c_int
    lib.sym_postorder.argtypes = [ctypes.c_int64, _i64p, _i64p]
    lib.sym_postorder.restype = ctypes.c_int
    lib.sym_counts.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _i64p]
    lib.sym_counts.restype = ctypes.c_int
    lib.sym_snode_rows.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p,
                                   _i64p, _i64p, ctypes.c_int64, _i64p, _i64p]
    lib.sym_snode_rows.restype = ctypes.c_int64
    return lib


@lru_cache(maxsize=1)
def load_ell():
    """Single-pass ELL layout builder (``ell_build`` in native/route.cpp);
    the rest of that file is the TPU route builder, which the port never
    calls."""
    lib = build_native_lib("hpctorch_route", "route.cpp")
    if lib is None or not hasattr(lib, "ell_build"):
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.ell_build.restype = ctypes.c_int64
    lib.ell_build.argtypes = [ctypes.c_int64] * 4 + [_i64p, i32p, i32p, i32p,
                                                     i32p, i32p, _i64p]
    return lib


def _blas_path() -> str | None:
    import scipy

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(scipy.__file__)),
                                  "scipy.libs", "libscipy_openblas*.so"))
    if libs:
        return libs[0]
    for cand in ("/usr/lib/x86_64-linux-gnu/libopenblas.so.0",
                 "/usr/lib/x86_64-linux-gnu/libblas.so.3"):
        if os.path.exists(cand):
            return cand
    return None


@lru_cache(maxsize=1)
def load_mf():
    lib = build_native_lib("hpctorch_mf", "mf.cpp", extra=("-ldl",))
    if lib is None:
        return None
    blas = _blas_path()
    if blas is None:
        return None
    lib.mf_init.argtypes = [ctypes.c_char_p]
    lib.mf_init.restype = ctypes.c_int
    if lib.mf_init(blas.encode()) != 0:
        return None

    _f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    for suffix, dt in (("d", np.float64), ("z", np.complex128)):
        fp = np.ctypeslib.ndpointer(dt, flags="C")
        f = getattr(lib, f"mf_factorize_{suffix}")
        f.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
                      _i64p, _i64p, _i64p, fp, _i64p, _i64p, fp, fp, fp, fp,
                      fp, ctypes.c_int, ctypes.c_double, _f64p]
        f.restype = ctypes.c_int64
        s = getattr(lib, f"mf_solve_{suffix}")
        s.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
                      _i64p, _i64p, fp, fp, fp, fp, fp, ctypes.c_int,
                      ctypes.c_int, fp]
        s.restype = None
        sm = getattr(lib, f"mf_solve_multi_{suffix}")
        sm.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
                       _i64p, _i64p, fp, fp, fp, fp, fp, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int64, fp]
        sm.restype = None
        # pivoted variants (within-front BK / partial-pivoting kernels)
        fpv = getattr(lib, f"mf_factorize_piv_{suffix}")
        fpv.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
                        _i64p, _i64p, _i64p, fp, _i64p, _i64p, fp, fp, fp,
                        fp, fp, ctypes.c_int, ctypes.c_double, fp, _i64p,
                        _i64p, _f64p]
        fpv.restype = ctypes.c_int64
        spv = getattr(lib, f"mf_solve_piv_{suffix}")
        spv.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
                        _i64p, _i64p, fp, fp, fp, fp, fp, ctypes.c_int,
                        ctypes.c_int, fp, fp, _i64p]
        spv.restype = None
        smv = getattr(lib, f"mf_solve_multi_piv_{suffix}")
        smv.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
                        _i64p, _i64p, fp, fp, fp, fp, fp, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int64, fp, fp, _i64p]
        smv.restype = None
        if hasattr(lib, f"mf_absmax2_{suffix}"):
            am = getattr(lib, f"mf_absmax2_{suffix}")
            am.argtypes = [fp, ctypes.c_int64, fp, ctypes.c_int64]
            am.restype = ctypes.c_double
    return lib


class NativeFactor:
    """Packed supernodal factors + the symbolic layout arrays the C engine
    consumes. Reusable across refactorizations (same pattern)."""

    def __init__(self, sym, dtype):
        self.sym = sym
        self.dtype = np.dtype(np.complex128 if np.issubdtype(dtype, np.complexfloating)
                              else np.float64)
        ns = sym.nsuper
        self.snode_ptr = np.ascontiguousarray(sym.snode_ptr, dtype=np.int64)
        nrs = np.array([len(r) for r in sym.snode_rows], dtype=np.int64)
        ncs = np.diff(self.snode_ptr)
        self.rows_ptr = np.concatenate([[0], np.cumsum(nrs)]).astype(np.int64)
        self.rows = (np.concatenate(sym.snode_rows).astype(np.int64)
                     if ns and self.rows_ptr[-1] else np.zeros(0, np.int64))
        self.sparent = np.ascontiguousarray(sym.snode_parent, dtype=np.int64)
        self.l11_off = np.concatenate([[0], np.cumsum(ncs * ncs)]).astype(np.int64)[:-1]
        self.l21_off = np.concatenate([[0], np.cumsum(nrs * ncs)]).astype(np.int64)[:-1]
        n11 = int((ncs * ncs).sum())
        n21 = int((nrs * ncs).sum())
        self.L11 = np.zeros(max(n11, 1), dtype=self.dtype)
        self.L21 = np.zeros(max(n21, 1), dtype=self.dtype)
        self.D = np.zeros(max(sym.n, 1), dtype=self.dtype)
        self.U11 = np.zeros(1, dtype=self.dtype)
        self.U12 = np.zeros(1, dtype=self.dtype)
        self.kind = None
        self.n_perturbed = 0
        # within-front pivoting state (kind 2/3 fallback kernels): 2x2
        # subdiagonals, factor-position -> pre-pivot-position map, and the
        # relabeled descendant scatter targets
        self.pivoted = False
        self.Dsub = np.zeros(1, dtype=self.dtype)
        self.pivperm = None
        self.rows2 = self.rows
        # max |L| entry, filled by the C++ factorize in the same pass that
        # exports the fronts (api.py:_factor_growth reads it for free)
        self._growth_buf = np.zeros(1, np.float64)
        self.growth = 0.0

    def _fn(self, lib, name):
        suffix = "z" if self.dtype == np.complex128 else "d"
        return getattr(lib, f"mf_{name}_{suffix}")

    def factorize(self, lib, Ap_csc, kind: str, eps: float,
                  pivot: bool = False) -> int:
        if kind == "lu" and self.U11.size == 1:
            self.U11 = np.zeros(self.L11.size, dtype=self.dtype)
            self.U12 = np.zeros(self.L21.size, dtype=self.dtype)
        self.kind = kind
        Ax = np.ascontiguousarray(Ap_csc.data, dtype=self.dtype)
        if pivot and hasattr(lib, f"mf_factorize_piv_"
                             f"{'z' if self.dtype == np.complex128 else 'd'}"):
            # within-front pivoted kernels (BK LDLt / partial-pivot LU) —
            # the escalation path when the static perturbation fires
            # (MUMPS CNTL(1) role, mumps_factorization.jl:176-224)
            self.pivoted = True
            if self.Dsub.size == 1:
                self.Dsub = np.zeros(max(self.sym.n, 1), dtype=self.dtype)
            self.pivperm = np.arange(self.sym.n, dtype=np.int64)
            self.rows2 = np.zeros_like(self.rows) \
                if self.rows.size else self.rows
            rc = self._fn(lib, "factorize_piv")(
                self.sym.n, self.sym.nsuper, self.snode_ptr, self.rows_ptr,
                self.rows, self.sparent,
                np.asarray(Ap_csc.indptr, np.int64),
                np.asarray(Ap_csc.indices, np.int64),
                Ax, self.l11_off, self.l21_off,
                self.L11, self.L21, self.D, self.U11, self.U12,
                2 if kind == "ldlt" else 3, eps,
                self.Dsub, self.pivperm, self.rows2, self._growth_buf,
            )
        else:
            self.pivoted = False
            self.pivperm = None
            self.rows2 = self.rows
            rc = self._fn(lib, "factorize")(
                self.sym.n, self.sym.nsuper, self.snode_ptr, self.rows_ptr,
                self.rows, self.sparent,
                np.asarray(Ap_csc.indptr, np.int64),
                np.asarray(Ap_csc.indices, np.int64),
                Ax, self.l11_off, self.l21_off,
                self.L11, self.L21, self.D, self.U11, self.U12,
                0 if kind == "ldlt" else 1, eps, self._growth_buf,
            )
        if rc < 0:
            raise RuntimeError(f"native factorization failed: {rc}")
        self.growth = float(self._growth_buf[0])
        self.n_perturbed = int(rc)
        return self.n_perturbed

    def _perms(self, transpose: bool):
        """(entry, exit) index arrays composing the fill-reducing perm with
        the within-front pivot map. The pivoted factor is of Q A_p Q^T
        (LDLt, symmetric swaps) or Q A_p (LU, row swaps), so:
          LDLt:        y = b[perm o piv]; x[perm o piv] = y
          LU:          y = b[perm o piv]; x[perm] = y
          LU transp.:  y = b[perm];       x[perm o piv] = y
        """
        perm = self.sym.perm
        if not self.pivoted:
            return perm, perm
        eperm = perm[self.pivperm]
        if self.kind == "ldlt":
            return eperm, eperm
        return (perm, eperm) if transpose else (eperm, perm)

    def solve(self, lib, b: np.ndarray, transpose: bool = False) -> np.ndarray:
        entry, exitp = self._perms(transpose)
        y = np.ascontiguousarray(b[entry], dtype=self.dtype)
        if self.pivoted:
            # rows2: L-sweep labels (relabeled to post-pivot ROW
            # positions); rows: U-sweep labels (column space, unpermuted)
            self._fn(lib, "solve_piv")(
                self.sym.n, self.sym.nsuper, self.snode_ptr, self.rows_ptr,
                self.rows2, self.l11_off, self.l21_off,
                self.L11, self.L21, self.D, self.U11, self.U12,
                0 if self.kind == "ldlt" else 1, 1 if transpose else 0, y,
                self.Dsub, self.rows,
            )
        else:
            self._fn(lib, "solve")(
                self.sym.n, self.sym.nsuper, self.snode_ptr, self.rows_ptr,
                self.rows, self.l11_off, self.l21_off,
                self.L11, self.L21, self.D, self.U11, self.U12,
                0 if self.kind == "ldlt" else 1, 1 if transpose else 0, y,
            )
        x = np.empty_like(y)
        x[exitp] = y
        return x

    def solve_multi(self, lib, B: np.ndarray,
                    transpose: bool = False) -> np.ndarray:
        """Blocked multi-RHS solve: B (n, k) -> X (n, k); one gemm-based
        sweep for all columns (ref gathers the whole RHS once,
        mumps_factorization.jl:291-353)."""
        entry, exitp = self._perms(transpose)
        Y = np.ascontiguousarray(B[entry], dtype=self.dtype)
        if self.pivoted:
            self._fn(lib, "solve_multi_piv")(
                self.sym.n, self.sym.nsuper, self.snode_ptr, self.rows_ptr,
                self.rows2, self.l11_off, self.l21_off,
                self.L11, self.L21, self.D, self.U11, self.U12,
                0 if self.kind == "ldlt" else 1, 1 if transpose else 0,
                Y.shape[1], Y, self.Dsub, self.rows,
            )
        else:
            self._fn(lib, "solve_multi")(
                self.sym.n, self.sym.nsuper, self.snode_ptr, self.rows_ptr,
                self.rows, self.l11_off, self.l21_off,
                self.L11, self.L21, self.D, self.U11, self.U12,
                0 if self.kind == "ldlt" else 1, 1 if transpose else 0,
                Y.shape[1], Y,
            )
        X = np.empty_like(Y)
        X[exitp] = Y
        return X
