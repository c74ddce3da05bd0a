"""The Helmholtz configuration kind, its plain reference and the
``factor_solves`` loop, on the CPU at grid 16.

The reference's ``apply`` equals the CSR values the kind hands the
program; the program's ``solve_matrix`` equals a dense solve of the
reference's operator; both cells of the loop (``helmholtz2d-512-c128.sweep64``
and ``poisson2d-512-chol.solves``) run whole through the harness, traced
and untraced, and come out correct, every per-layer reader of the cell
finding a number in the traced run (with the graphs stood in for on the
CPU, so that the capture's span exists); the single-RHS cell builds no
plan and refactorizes nothing in its window; and three faults each make
``correct`` false: a factor that takes the conjugate transpose where the
complex-symmetric LDLᵀ takes the plain one, the damping dropped from the
values handed to the program, and the program in complex64.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pbcore import spec
from pbtest_util import cpu_run, small_cell
from reference import helmholtz as ref

HELM = "helmholtz2d-512-c128.sweep64"
SOLVES = "poisson2d-512-chol.solves"
# grid 16 holds 8 sources at row 1, columns 1, 3, ..., 15
SMALL_SOURCES = {"sources": {"row": 1, "first_column": 1, "spacing": 2}}


def _kind():
    return spec.load_module("problems", "helmholtz2d")


def _small(name, **config):
    if name == HELM:
        cell = small_cell(name, **{**SMALL_SOURCES, **config})
        cell.traffic["rhs_columns"] = 8
        return cell
    return small_cell(name, **config)


def _operators(P=3, k=16, seed=2 ** 33 + 5):
    cfg = {**spec.Cell(HELM).config, "grid": k, **SMALL_SOURCES}
    kind = _kind()
    gen = torch.Generator().manual_seed(seed)
    f = kind.fields(cfg, P, gen, "cpu")
    csr = kind.matrix(cfg)
    V = kind.values(f)
    return cfg, kind, f, csr, V


def test_the_fields_follow_the_configuration():
    cfg, _kind_, (s, mu, eta), _csr, _V = _operators(P=8)
    ppw = 8 + 4 * torch.arange(8, dtype=torch.float64) / 7
    torch.testing.assert_close(s, (2 * np.pi / ppw) ** 2, rtol=0, atol=0)
    assert round(float(s[0]), 3) == 0.617 and round(float(s[-1]), 3) == 0.274
    assert 0.8 <= float(mu.min()) and float(mu.max()) <= 1.2
    assert eta == 0.1


def test_reference_apply_equals_the_programs_csr():
    _cfg, _k, (s, mu, eta), csr, V = _operators()
    n = csr.shape[0]
    X = torch.randn(n, 5, dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(3))
    for p in range(V.shape[0]):
        Ap = sp.csr_matrix((V[p].numpy(), csr.indices, csr.indptr),
                           shape=csr.shape)
        # complex-symmetric, not Hermitian
        assert abs(Ap - Ap.T).max() == 0 and abs(Ap - Ap.T.conj()).max() > 0
        want = torch.from_numpy(Ap @ X.numpy())
        got = ref.apply(s[p], mu[p], eta, X)
        torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
        torch.testing.assert_close(ref.apply(s[p], mu[p], eta, X[:, 0]),
                                   want[:, 0], rtol=1e-14, atol=1e-14)


def test_the_sources_are_unit_points_along_the_top():
    cfg, kind, *_ = _operators()
    B = kind.rhs(cfg, 8, "cpu")
    rows = B.abs().argmax(dim=0)
    assert rows.tolist() == [16 + 1 + 2 * c for c in range(8)]
    assert float(B.abs().sum()) == 8
    assert kind.rhs(spec.Cell(HELM).config, 64, "cpu").abs().argmax(
        dim=0).tolist() == [512 + 4 + 8 * c for c in range(64)]
    with pytest.raises(ValueError):
        kind.rhs(cfg, 9, "cpu")


def test_the_programs_block_solve_equals_a_dense_solve():
    import hpclinalg_torch as ht

    cfg, kind, (s, mu, eta), csr, V = _operators()
    n = csr.shape[0]
    B = kind.rhs(cfg, 8, "cpu")
    Ad = ref.apply(s[1], mu[1], eta, torch.eye(n, dtype=torch.complex128))
    want = torch.linalg.solve(Ad, B)
    be = ht.backend_auto(1, dtype=np.complex128, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(sp.csr_matrix(
        (V[1].numpy(), csr.indices, csr.indptr), shape=csr.shape), be)
    F = ht.ldlt(A, method="device")
    assert F.kind == "ldl" and F.n_perturbed == 0
    X = torch.from_numpy(np.asarray(F.solve_matrix(
        ht.DistDenseMatrix.from_global(B.numpy(), be)).to_numpy()))
    torch.testing.assert_close(X, want, rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))
    assert float(ref.relative_residuals(s[1], mu[1], eta, X, B).max()) \
        <= 1e-12


def _stand_in_graphs(monkeypatch):
    """``utils/graphs``' capture on the CPU: the record runs the step once
    and a replay reruns it into the returned tensors, so that the device
    solver takes its graphed path and opens its capture span."""
    from hpclinalg_torch.utils import graphs

    class Graph:
        def __init__(self, fn):
            self.fn, self.out = fn, fn()

        def replay(self):
            held, graphs._held = graphs._held, {}
            try:
                new = self.fn()
            finally:
                graphs._held = held
            for dst, src in zip(_flat(self.out), _flat(new)):
                if dst is not src:
                    dst.copy_(src)

    def record(fn, device):
        g = Graph(fn)
        return g, g.out, {"capture_s": 0.0, "instantiate_s": 0.0}

    monkeypatch.setattr(graphs, "record", record)
    monkeypatch.setattr(graphs, "warm_up", lambda fn, device: fn())
    monkeypatch.setattr(graphs, "_device_refusal", lambda tensors: None)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: {"kernel": 1})


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _flat(x)]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", [HELM, SOLVES])
def test_a_cell_runs_whole_and_is_correct(name, traced, monkeypatch):
    if traced:
        _stand_in_graphs(monkeypatch)
    cell = _small(name)
    rec = cpu_run(cell, trace=traced)
    assert rec.correct and rec.failed == 0 and rec.attempted >= 1
    assert rec.checks["rel_residual"][0] <= 1e-12
    assert rec.notes["plans_built_in_window"] == {}
    assert rec.notes["checked_requests"] >= 1
    assert rec.rates["factor_solve_ms"] > 0
    assert len(rec.solve_ms) == rec.attempted
    assert len(rec.refactor_ms) == (rec.attempted if name == HELM else 0)
    if not traced:
        assert "program_setup" not in rec.notes
        return
    assert rec.notes["graphed"] is True
    for m in cell.per_layer:
        v = spec.load_reader(m["name"])(rec)
        assert v is not None and np.isfinite(v), m["name"]
    got = rec.notes["program_traced"]
    ntr = cell.traffic["trace_requests"]
    want_cols = ntr * cell.traffic["rhs_columns"]
    assert got["counters"]["solver.rhs_columns"] == want_cols
    if name == HELM:
        assert got["spans"]["solver.refactorize"]["calls"] == ntr
        assert got["spans"]["solver.solve_matrix"]["calls"] == ntr
        assert rec.notes["program_setup"]["spans"]["graph.capture"][
            "calls"] == 2   # the factor graph and the block's solve graph
    else:
        # factored at set-up: no refactorization among the requests
        assert "solver.refactorize" not in got["spans"]
        assert got["spans"]["solver.solve"]["calls"] == ntr


def _values_without_damping(real):
    def values(f):
        v = real(f)
        return v.real.to(v.dtype)
    return values


def _hermitian_right_solve(L, B, unit=False):
    return torch.linalg.solve_triangular(L.mH, B, upper=True, left=False,
                                         unitriangular=unit)


@pytest.mark.parametrize("fault", ["hermitian", "undamped", "complex64"])
def test_a_broken_helmholtz_run_is_not_correct(fault, monkeypatch):
    config = {}
    if fault == "hermitian":
        from hpclinalg_torch.solver import device_mf

        monkeypatch.setattr(device_mf, "_right_lower_t",
                            _hermitian_right_solve)
    elif fault == "undamped":
        kind = _kind()
        monkeypatch.setattr(kind, "values",
                            _values_without_damping(kind.values))
    else:
        config["dtype"] = "complex64"
    rec = cpu_run(_small(HELM, **config))
    assert not rec.correct and rec.failed >= 1
    # by orders of magnitude
    assert rec.checks["rel_residual"][0] > 100 * 1e-9


def test_a_sound_helmholtz_run_is_correct_beside_them():
    rec = cpu_run(_small(HELM))
    assert rec.correct and rec.checks["rel_residual"][0] <= 1e-12
