"""The control of each cell's comparison, at a size the CPU holds: the
program in the nearest precision below the configuration's (f32 for f64),
through the harness's whole run, must come out not correct. On the card it
was run at each cell's own size on three seeds (``PERF.md`` gives the
readings the limits were set from)."""

import pytest

from pbtest_util import cpu_run, small_cell


@pytest.mark.parametrize("name, ranks, steady", [
    ("hpcg-104.cg50", 1, "x_rel_err"),
    ("poisson2d-512-chol.refactor", 1, "rel_residual"),
    ("hpcg-104.cg50", 4, "x_rel_err")])
def test_the_program_in_f32_is_not_correct(name, ranks, steady):
    rec = cpu_run(small_cell(name, ranks, dtype="float32"))
    assert not rec.correct
    assert rec.failed >= 1
    # the number that is steady from seed to seed fails by orders of
    # magnitude (the residual's, after 8 steps on 2048 rows, by less)
    value, limit = rec.checks[steady]
    assert value > 100 * limit
