"""Analyzer host phases: the compute thread's CPU seconds over its wall
seconds inside the window's ``S:analyze_batch`` spans, in percent, from
the counter ``S:analyze_batch/cpu_ns``. What is missing was spent
waiting: for the interpreter lock, or on a device sync."""


def read(run):
    wall, _ = run.timer.get('S:analyze_batch', (0.0, 0))
    _, cpu_ns = run.timer.get('S:analyze_batch/cpu_ns', (0.0, 0))
    if wall <= 0 or not cpu_ns:
        return None
    return 100.0 * cpu_ns / 1e9 / wall
