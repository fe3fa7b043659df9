"""Small host-side utilities: stderr printing and exit, directory creation,
interval union, the per-read unknown_error report, and per-stage wall-time
accounting with its span log."""

import contextlib
import itertools
import os
import sys
import threading
import time
import traceback
from collections import defaultdict, namedtuple


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


class Span(namedtuple(
        'Span', 'id name start_ns end_ns cpu_ns thread parent batch kind')):
    """One span of the span log. ``start_ns``/``end_ns`` are
    ``time.perf_counter_ns()``; ``cpu_ns`` the thread's CPU time inside
    the span (``time.thread_time_ns()``), None where the span was added
    with its length alone; ``parent`` the id of the span open on the same
    thread around it, or None; ``batch`` the session's batch id on that
    thread, or None. ``kind``: 'timed' (a block timed by
    ``StageTimer.stage``), 'interval' (added with its length, ending when
    it was added) or 'sum' (the time of several calls inside the parent,
    added as one: its start and end are not an interval)."""
    __slots__ = ()


class SpanLog:
    """The spans and counter increments of a StageTimer while it records.
    ``anchor`` is one pair (perf_counter_ns, time.time_ns()) taken when
    recording started: torch.profiler stamps its events in epoch
    nanoseconds, and ``epoch_ns`` maps a span's times onto them."""

    def __init__(self):
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        self.anchor = ((p0 + p1) // 2, wall)
        self.spans = []
        # (name, n, perf_counter_ns, thread, parent, batch)
        self.counts = []
        self._ids = itertools.count()
        self._local = threading.local()

    def epoch_ns(self, perf_ns):
        return perf_ns - self.anchor[0] + self.anchor[1]

    def _stack(self):
        """This thread's open spans: [id, name, start_ns, cpu_ns, parent]."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _parent(self):
        stack = self._stack()
        return stack[-1][0] if stack else None

    def open(self, name):
        parent = self._parent()
        self._stack().append([next(self._ids), name, time.perf_counter_ns(),
                              time.thread_time_ns(), parent])

    def mark_sum(self, name):
        self._local.sum_of = name

    def close(self, name, seconds, batch):
        """The end of a span: the block open on top of this thread's stack
        when it has ``name``, else one added with its length alone."""
        cpu, end = time.thread_time_ns(), time.perf_counter_ns()
        stack = self._stack()
        if stack and stack[-1][1] == name:
            sid, _, start, cpu0, parent = stack.pop()
            span = Span(sid, name, start, end, cpu - cpu0,
                        threading.get_ident(), parent, batch, 'timed')
        else:
            kind = 'interval'
            if getattr(self._local, 'sum_of', None) == name:
                kind = 'sum'
                self._local.sum_of = None
            span = Span(next(self._ids), name, end - round(seconds * 1e9),
                        end, None, threading.get_ident(), self._parent(),
                        batch, kind)
        self.spans.append(span)

    def count(self, name, n, batch):
        self.counts.append((name, n, time.perf_counter_ns(),
                            threading.get_ident(), self._parent(), batch))


class StageTimer:
    """Wall time and call count per named pipeline stage, and counters (a
    count and no time). While ``recording`` it also keeps every span in a
    SpanLog. Every span passes through ``add`` at its end."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = set()
        self.log = None
        self._local = threading.local()

    @contextlib.contextmanager
    def recording(self):
        """Keep every span and counter increment of the block in a SpanLog,
        which the block gets."""
        if self.log is not None:
            raise RuntimeError('the span log is already recording')
        log = self.log = SpanLog()
        try:
            yield log
        finally:
            self.log = None

    @contextlib.contextmanager
    def batch(self, batchid):
        """Spans on this thread inside the block belong to batch
        ``batchid``."""
        self._local.batch = batchid
        try:
            yield
        finally:
            self._local.batch = None

    @contextlib.contextmanager
    def stage(self, name, cpu=False):
        """Time the block as the stage ``name``. With ``cpu``, the thread's
        CPU nanoseconds inside it also go to the counter
        ``<name>/cpu_ns``."""
        log = self.log
        if log is not None:
            log.open(name)
        cpu0 = time.thread_time_ns() if cpu else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)
            if cpu:
                self.count(name + '/cpu_ns', time.thread_time_ns() - cpu0)

    def add(self, name, seconds):
        """One call of a stage that took ``seconds``, ending now."""
        with self.lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            if self.log is not None:
                self.log.close(name, seconds,
                               getattr(self._local, 'batch', None))

    def add_sum(self, name, seconds):
        """``add`` of the time of several calls inside the span open on this
        thread; the span log marks it as a sum, not an interval."""
        log = self.log
        if log is not None:
            log.mark_sum(name)
        self.add(name, seconds)

    def count(self, name, n):
        """Add ``n`` to the counter ``name``: in ``totals`` with no time, in
        ``counts`` with ``n``."""
        with self.lock:
            self.totals[name] += 0.0
            self.counts[name] += n
            self.counters.add(name)
            if self.log is not None:
                self.log.count(name, n, getattr(self._local, 'batch', None))

    def snapshot(self):
        with self.lock:
            return {name: ({'count': self.counts[name]}
                           if name in self.counters else
                           {'total_s': round(self.totals[name], 4),
                            'calls': self.counts[name],
                            'mean_ms': round(
                                1000 * self.totals[name] /
                                max(1, self.counts[name]), 3)})
                    for name in sorted(self.totals)}

    def report(self, logger):
        for name, row in self.snapshot().items():
            if 'count' in row:
                logger.info('stage %-28s count %8d', name, row['count'])
            else:
                logger.info('stage %-28s total %8.2fs  calls %6d  '
                            'mean %8.2fms', name, row['total_s'],
                            row['calls'], row['mean_ms'])


GLOBAL_TIMER = StageTimer()


def trace(name):
    """Time a block into GLOBAL_TIMER as the stage ``name``."""
    return GLOBAL_TIMER.stage(name)
