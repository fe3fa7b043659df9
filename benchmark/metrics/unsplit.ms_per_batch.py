"""Unsplit filter: the milliseconds of ``C:unsplit_viterbi`` and
``C:unsplit_analyze`` a batch."""


def read(run):
    total = sum(run.timer.get(name, (0.0, 0))[0]
                for name in ('C:unsplit_viterbi', 'C:unsplit_analyze'))
    if not total or not run.batches:
        return None
    return 1e3 * total / run.batches
