"""Poly(A) rounds: the milliseconds of ``C:polya`` a batch."""


def read(run):
    total, _ = run.timer.get('C:polya', (0.0, 0))
    if not total or not run.batches:
        return None
    return 1e3 * total / run.batches
