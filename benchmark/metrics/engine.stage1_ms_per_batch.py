"""Stage-1 engine: the milliseconds of ``B:device_stage1`` a batch (pack,
copy, the scaler, segmentation and demux networks, copy back)."""


def read(run):
    total, _ = run.timer.get('B:device_stage1', (0.0, 0))
    if not total or not run.batches:
        return None
    return 1e3 * total / run.batches
