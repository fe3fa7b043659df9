"""The benchmark of poreplex_torch: one CLI session over simulated reads a
run (``run.py``), its traffic, configurations, per-layer metric readers and
the plain reference that decides whether the session's outputs are
correct."""
