"""Poly(A) rounds: the calls of ``C:polya/round`` a batch (one round
launches every window bucket's fused program once)."""


def read(run):
    _, rounds = run.timer.get('C:polya/round', (0.0, 0))
    if not rounds or not run.batches:
        return None
    return rounds / run.batches
