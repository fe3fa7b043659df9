"""CLI and session: the compute thread's idle milliseconds a batch, the
sum of the ``W:compute_waits_load`` and ``W:compute_handoff`` spans (the
wait for the batch's PHASE A, then the event loop's hand-off) over the
window's batches."""

WAITS = ('W:compute_waits_load', 'W:compute_handoff')


def read(run):
    total = sum(run.timer.get(name, (0.0, 0))[0] for name in WAITS)
    if not total or not run.batches:
        return None
    return 1e3 * total / run.batches
