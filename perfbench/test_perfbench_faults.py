"""A run of each cell with its timed path broken underneath, through the
rest of the harness on the CPU (the look for a card skipped): each fault
the cell can have must make ``correct`` come out false. CG: a step that
returns its state unchanged, an iterate altered where the step produces
it, and (four ranks) the exchange between the ranks left out. Direct: a
refactorization that keeps the previous factors, and a solution altered
where the solve produces it."""

import functools

import pytest
import torch

from pbcore import main
from pbtest_util import cpu_run, small_cell


def _broken_step_fn(real, fault):
    def cg_step_fn(A, be):
        step, x0 = real(A, be)

        def broken(x, r, p, out=None):
            if fault == "unchanged":
                return x, r, p
            x2, r2, p2 = step(x, r, p, out=out)
            x2.view(-1)[0] += 1.0
            return x2, r2, p2

        broken.backend, broken.plan, broken.engine = \
            step.backend, step.plan, step.engine
        return broken, x0
    return cg_step_fn


def _break_step(fault):
    from hpclinalg_torch import entry

    entry.cg_step_fn = _broken_step_fn(entry.cg_step_fn, fault)


def child_with_broken_step(fault, *args):
    _break_step(fault)
    main.child(*args)


def _drop_exchange():
    """Nothing arrives from the other ranks: each all_to_all returns zeros."""
    from hpclinalg_torch.parallel import comm

    comm.all_to_all_v = lambda backend, send, in_splits, out_splits: \
        send.new_zeros(int(sum(out_splits)))


def child_without_exchange(*args):
    _drop_exchange()
    main.child(*args)


@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_cg_step_is_not_correct(ranks, fault, monkeypatch):
    from hpclinalg_torch import entry

    monkeypatch.setattr(entry, "cg_step_fn", entry.cg_step_fn)
    _break_step(fault)
    # every rank runs the broken step
    rec = cpu_run(small_cell("hpcg-104.cg50", ranks),
                  child_entry=functools.partial(
        child_with_broken_step, fault))
    assert not rec.correct and rec.failed >= 1


def test_the_exchange_left_out_is_not_correct(monkeypatch):
    from hpclinalg_torch.parallel import comm

    monkeypatch.setattr(comm, "all_to_all_v", comm.all_to_all_v)
    _drop_exchange()
    rec = cpu_run(small_cell("hpcg-104.cg50", 4),
                  child_entry=child_without_exchange)
    assert not rec.correct and rec.failed >= 1


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_device_solver_is_not_correct(fault, monkeypatch):
    from hpclinalg_torch.solver import device_mf

    cls = device_mf.DeviceFactorization
    if fault == "unchanged":
        monkeypatch.setattr(cls, "refactorize", lambda self, A: self)
    else:
        real = cls.solve

        def solve(self, b, *a, **kw):
            x = real(self, b, *a, **kw)
            x.data.view(-1)[0] += 1.0
            return x
        monkeypatch.setattr(cls, "solve", solve)
    rec = cpu_run(small_cell("poisson2d-512-chol.refactor"))
    assert not rec.correct and rec.failed >= 1


def test_a_sound_solver_run_is_correct_beside_them():
    rec = cpu_run(small_cell("poisson2d-512-chol.refactor"))
    assert rec.correct and torch.isfinite(torch.tensor(
        rec.checks["rel_residual"][0]))
