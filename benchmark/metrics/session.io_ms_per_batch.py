"""CLI and session: the writers' milliseconds a batch, the sum of the
``D:io_*`` spans (one a sink) over the window's batches."""


def read(run):
    total = sum(t for name, (t, _) in run.timer.items()
                if name.startswith('D:io_'))
    if not total or not run.batches:
        return None
    return 1e3 * total / run.batches
