"""graph_capture_s.helm: the program's ``graph.capture`` span, total
seconds in set-up (each ``CapturedStep``'s warm-up call, record and
instantiation: the LDLᵀ factor graph at ``ldlt`` and the solve graph at
the block's width at the first solve). Moves setup_s."""


def read(run):
    rep = run.notes.get("program_setup")
    if not rep or "graph.capture" not in rep["spans"]:
        return None
    return rep["spans"]["graph.capture"]["total_s"]
