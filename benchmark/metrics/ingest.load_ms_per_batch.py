"""Ingest (PHASE A): the milliseconds of ``A:fast5_load`` a batch."""


def read(run):
    total, _ = run.timer.get('A:fast5_load', (0.0, 0))
    if not total or not run.batches:
        return None
    return 1e3 * total / run.batches
