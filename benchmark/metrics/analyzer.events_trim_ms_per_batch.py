"""Analyzer host phases: the milliseconds of ``C:events_trim`` a batch
(basecalled events, trimming and the unsplit windows' collection)."""


def read(run):
    total, _ = run.timer.get('C:events_trim', (0.0, 0))
    if not total or not run.batches:
        return None
    return 1e3 * total / run.batches
