"""The traced run's readings: the program's stage spans with their start
and end, and the device's kernel and copy spans from torch.profiler.

The program times its stages into ``utils.GLOBAL_TIMER`` as totals; the
recorder wraps that timer's ``add`` for the window, so each span is kept
with its end on the host's clock and its thread. The device is traced
alone (no host operators, shapes or stacks), and the profiler's raw
events are read after the window. A marker kernel launched at a known
host time puts both on one clock."""

import threading
import time

import torch

MARKER = 'spin_kernel'


class SpanRecorder:

    def __init__(self, timer):
        self.timer = timer
        self.spans = []          # (name, start s, end s, thread id)
        self._add = None

    def __enter__(self):
        self._add = self.timer.add
        spans, add = self.spans, self._add

        def recording_add(name, seconds):
            end = time.perf_counter()
            spans.append((name, end - seconds, end, threading.get_ident()))
            add(name, seconds)
        self.timer.add = recording_add
        return self

    def __exit__(self, *exc):
        del self.timer.add


class DeviceTrace:
    """torch.profiler over the device alone. ``spans`` are (start s, end
    s, name) on the host's perf_counter clock, kernels and copies only."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.marker_host = self._marker()
        return self

    @staticmethod
    def _marker():
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        return t

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        from torch.autograd import DeviceType
        raw = []
        marker = None
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            name = e.name()
            if name.startswith('Activity Buffer'):
                continue
            if MARKER in name and marker is None:
                marker = e.start_ns()
                continue
            raw.append((e.start_ns(), e.end_ns(), name))
        if marker is None:
            raise RuntimeError('the device trace holds no marker kernel')
        self.spans = sorted(((s - marker) / 1e9 + self.marker_host,
                             (t - marker) / 1e9 + self.marker_host, name)
                            for s, t, name in raw)


def union(intervals):
    """Merged (start, end) intervals of sorted (start, end, ...) spans."""
    merged = []
    for start, end, *_ in intervals:
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def busy_seconds(spans, t0, t1):
    """Seconds within [t0, t1] in which a kernel or copy ran."""
    return sum(max(0.0, min(e, t1) - max(s, t0))
               for s, e in union(spans))


def device_ops(spans, top=10):
    """[[kernel name, seconds]] of the names that took the most time."""
    by_name = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return [[name, sec] for name, sec in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(spans, host_spans, t0, t1, top=10):
    """[[host span, seconds]]: the device's idle time within [t0, t1]
    summed by the stage span open on the host in the middle of each gap:
    the innermost one off PHASE A, else the outermost PHASE A span
    (``A:``, on a monitor thread); '(between stages)' where none is."""
    gaps, cursor = [], t0
    for s, e in union(spans):
        if s > cursor:
            gaps.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
        if cursor >= t1:
            break
    if cursor < t1:
        gaps.append((cursor, t1))
    ordered = sorted(host_spans, key=lambda h: h[1])
    by_name, active, at = {}, [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while at < len(ordered) and ordered[at][1] <= mid:
            active.append(ordered[at])
            at += 1
        active = [h for h in active if h[2] >= mid]
        best = None
        for name, hs, he, _ in active:
            phase_a = name.startswith('A:')
            rank = (not phase_a, hs if not phase_a else he - hs)
            if best is None or rank > best[0]:
                best = (rank, name)
        name = best[1] if best else '(between stages)'
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0)
    return [[name, sec] for name, sec in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
