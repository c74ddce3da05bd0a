"""host_syncs.helm: the program's ``solver.host_reads`` counter (the
factor's stats read, each norm the refinement reads) over the traced
requests, a request. Moves factor_solve_ms."""


def read(run):
    rep = run.notes.get("program_traced")
    ntr = run.notes.get("traced_requests")
    if not rep or not ntr or "solver.host_reads" not in rep["counters"]:
        return None
    return rep["counters"]["solver.host_reads"] / ntr
