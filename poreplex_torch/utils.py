"""Small host-side utilities: stderr printing and exit, directory creation,
interval union, the per-read unknown_error report, and per-stage wall-time
accounting."""

import contextlib
import os
import sys
import threading
import time
import traceback
from collections import defaultdict


def errprint(*args, **kwargs):
    kwargs.setdefault('file', sys.stderr)
    print(*args, **kwargs)


def errx(message):
    """Print to stderr and exit with status 1."""
    errprint(message)
    sys.exit(1)


def ensure_dir_exists(filepath):
    """Create the parent directory of a file path when missing."""
    dirname = os.path.dirname(filepath)
    if dirname and not os.path.isdir(dirname):
        os.makedirs(dirname, exist_ok=True)


def union_intervals(intervals):
    """Merge overlapping or touching [begin, end] intervals into a new
    sorted list."""
    if not intervals:
        return []
    ordered = sorted([list(iv) for iv in intervals])
    merged = [ordered[0][:]]
    for begin, end in ordered[1:]:
        if begin <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([begin, end])
    return merged


def pack_unhandled_exception(f5filename, read_id, exc, exc_tb=None):
    """Per-read unknown_error report dict in upstream poreplex's message
    format."""
    if exc_tb is None:
        exc_tb = sys.exc_info()[2]
    srcfilename = os.path.split(
        exc_tb.tb_frame.f_code.co_filename)[-1] if exc_tb else '?'
    errmsg = ('[{src}:{line}] ({f5}#{rid}) Unhandled exception '
              '{name}: {msg}\n{tb}'.format(
                  src=srcfilename,
                  line=exc_tb.tb_lineno if exc_tb else 0,
                  f5=f5filename, rid=read_id, name=type(exc).__name__,
                  msg=str(exc), tb=traceback.format_exc()))
    return {'filename': f5filename, 'read_id': read_id,
            'status': 'unknown_error', 'error_message': errmsg}


class StageTimer:
    """Wall time and call count per named pipeline stage."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name, seconds):
        """One call of a stage that took ``seconds``."""
        with self.lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def snapshot(self):
        with self.lock:
            return {name: {'total_s': round(self.totals[name], 4),
                           'calls': self.counts[name],
                           'mean_ms': round(
                               1000 * self.totals[name] /
                               max(1, self.counts[name]), 3)}
                    for name in sorted(self.totals)}

    def report(self, logger):
        for name, row in self.snapshot().items():
            logger.info('stage %-28s total %8.2fs  calls %6d  mean %8.2fms',
                        name, row['total_s'], row['calls'], row['mean_ms'])


GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def trace(name):
    """Time a block into GLOBAL_TIMER, and mark it as a range in a
    ``torch.profiler`` trace when one is recording."""
    import torch
    with GLOBAL_TIMER.stage(name), torch.profiler.record_function(name):
        yield
