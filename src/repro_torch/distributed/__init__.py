"""Curvature-refresh planning (mirrors ``repro/distributed``): so far the
cost-model planner, :mod:`.plan`, which the staggered refresh reads.  The
sharded and overlapped refresh services wait for the distributed slice."""
