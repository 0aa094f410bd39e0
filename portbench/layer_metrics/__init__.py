"""Per-layer metrics: one reader a metric, found by the metric's name.

Each module declares the layer (as PERF.md's list of layers names it), the
unit, the source and the end-to-end metric it should move, and defines
`read(win, log)`, which takes the metric from a traced run's `Window`
(portbench/run.py) and returns a number, or None where the run holds
nothing to read.
"""
