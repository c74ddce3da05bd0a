"""refine_sweeps.helm: the program's ``solver.refine_sweeps`` counter (each
refinement sweep that solves again) over the traced requests, a request.
A program that counts the columns it solves (``solver.rhs_columns``) and
counted no sweep made none: 0. Moves factor_solve_ms."""


def read(run):
    rep = run.notes.get("program_traced")
    ntr = run.notes.get("traced_requests")
    if not rep or not ntr or "solver.rhs_columns" not in rep["counters"]:
        return None
    return rep["counters"].get("solver.refine_sweeps", 0) / ntr
