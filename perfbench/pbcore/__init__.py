"""The benchmark's harness: the specification and its lookup by name, the
input generators, the ranks' environment, the reading of traces, and the
result line. ``run.py`` beside this package is the command; the traffic
loops, configuration kinds and metric readers are files of their own
(``loops/``, ``problems/``, ``metrics/``)."""
