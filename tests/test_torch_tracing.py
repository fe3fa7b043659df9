"""The span log of poreplex_torch.utils.StageTimer on the CPU: nested
spans with their parent, batch id, thread and thread CPU time; nothing
recorded with the log off, and the same totals; counters; the anchor
that maps a span onto a torch.profiler range; and a session's
``S:analyze_batch`` and ``W:`` spans, which tile the compute thread's
idle time between batches."""

import contextlib
import logging
import threading
import time
import types

import pytest

from poreplex_torch.config import build_config
from poreplex_torch.pipeline.source import MemorySource
from poreplex_torch.utils import GLOBAL_TIMER, StageTimer

LOGGER = logging.getLogger('test-torch-tracing')
# nanoseconds of float rounding allowed between perf_counter() seconds and
# perf_counter_ns()
CLOCK_NS = 1000


def busy(seconds):
    """Spend ``seconds`` of this thread's CPU time."""
    end = time.thread_time() + seconds
    while time.thread_time() < end:
        pass


def test_nested_spans_carry_parent_batch_and_thread():
    timer = StageTimer()
    threads = {}

    def work(batchid):
        threads[batchid] = threading.get_ident()
        with timer.batch(batchid):
            with timer.stage('outer'):
                with timer.stage('inner'):
                    busy(0.002)
                    time.sleep(0.005)
                timer.add_sum('part', 0.001)
        with timer.stage('unbatched'):
            pass

    with timer.recording() as log:
        workers = [threading.Thread(target=work, args=(b,)) for b in (7, 8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    assert len(log.spans) == 8
    for batchid in (7, 8):
        mine = {s.name: s for s in log.spans
                if s.thread == threads[batchid]}
        outer, inner, part = mine['outer'], mine['inner'], mine['part']
        assert (outer.parent, inner.parent, part.parent) == (
            None, outer.id, outer.id)
        assert outer.batch == inner.batch == part.batch == batchid
        assert mine['unbatched'].batch is None
        assert (outer.kind, inner.kind, part.kind) == ('timed', 'timed',
                                                       'sum')
        assert outer.start_ns <= inner.start_ns < inner.end_ns <= \
            outer.end_ns
        assert part.cpu_ns is None
        for span in (outer, inner):
            assert 0 < span.cpu_ns <= span.end_ns - span.start_ns
        # the sleep is wall time and no CPU time
        assert inner.cpu_ns < inner.end_ns - inner.start_ns - 4e6
        assert inner.cpu_ns >= 2e6


@pytest.mark.parametrize('record', [False, True])
def test_stage_counts_its_thread_cpu(record):
    timer = StageTimer()
    with (timer.recording() if record else contextlib.nullcontext()) as log:
        for _ in range(2):
            with timer.stage('compute', cpu=True):
                busy(0.002)
                time.sleep(0.005)
        with timer.stage('plain'):
            busy(0.001)
    wall, calls = timer.totals['compute'], timer.counts['compute']
    cpu_ns = timer.counts['compute/cpu_ns']
    assert calls == 2 and 'compute/cpu_ns' in timer.counters
    assert 4e6 <= cpu_ns <= wall * 1e9 - 8e6
    assert 'plain/cpu_ns' not in timer.totals
    if record:
        spans = [s for s in log.spans if s.name == 'compute']
        counted = [n for name, n, *_ in log.counts
                   if name == 'compute/cpu_ns']
        assert len(counted) == 2
        # the counter holds the span's CPU time, its clock read a little
        # later at both ends
        for span, n in zip(spans, counted):
            assert abs(n - span.cpu_ns) <= 1e6


def workload(timer):
    """Spans and counters of fixed lengths and counts, and one timed
    block."""
    with timer.batch(1):
        with timer.stage('outer'):
            with timer.stage('inner'):
                pass
            timer.add_sum('part', 0.25)
        timer.add('gap', 0.5)
        timer.count('windows', 3)
        timer.count('windows', 4)


def test_log_off_records_nothing_and_keeps_the_totals():
    on, off = StageTimer(), StageTimer()
    with on.recording() as log:
        workload(on)
    recorded = (len(log.spans), len(log.counts))
    assert recorded == (4, 2)
    assert on.log is None
    workload(off)
    assert off.log is None
    on_rows, off_rows = on.snapshot(), off.snapshot()
    assert on_rows.keys() == off_rows.keys() == {
        'outer', 'inner', 'part', 'gap', 'windows'}
    for name in ('part', 'gap', 'windows'):
        assert on_rows[name] == off_rows[name], name
    for name in ('outer', 'inner'):
        assert on_rows[name]['calls'] == off_rows[name]['calls'] == 1
    assert on_rows['windows'] == {'count': 7}
    # once the block has ended, nothing more is recorded
    workload(on)
    assert (len(log.spans), len(log.counts)) == recorded
    assert on.counts['gap'] == 2


def test_count_shows_in_snapshot_and_report():
    timer = StageTimer()
    timer.count('C:polya/windows@8192', 5)
    timer.count('C:polya/windows@8192', 2)
    timer.add('C:polya/launch', 0.5)
    rows = timer.snapshot()
    assert rows['C:polya/windows@8192'] == {'count': 7}
    assert rows['C:polya/launch']['calls'] == 1
    # the name -> (seconds, count) mapping a reader builds from totals
    mapping = {name: (timer.totals[name], timer.counts[name])
               for name in timer.totals}
    assert mapping['C:polya/windows@8192'] == (0.0, 7)
    lines = []
    timer.report(types.SimpleNamespace(
        info=lambda fmt, *args: lines.append(fmt % args)))
    assert any(line.startswith('stage C:polya/windows@8192') and
               line.split()[-2:] == ['count', '7'] for line in lines)


def test_one_recording_at_a_time():
    timer = StageTimer()
    with timer.recording():
        with pytest.raises(RuntimeError):
            with timer.recording():
                pass


def test_anchor_maps_spans_onto_profiler_ranges():
    """After one warm-up range, a span mapped by the anchor starts and
    ends within 1 ms of the record_function range it encloses."""
    from torch.profiler import ProfilerActivity, profile, record_function
    timer = StageTimer()
    names = ['probe{}'.format(k) for k in range(4)]
    with timer.recording() as log, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            with timer.stage(name), record_function(name):
                time.sleep(0.005)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in names}
    spans = {s.name: s for s in log.spans}
    for name in names[1:]:
        span, event = spans[name], ranges[name]
        assert abs(log.epoch_ns(span.start_ns) - event.start_ns()) < 1e6
        assert abs(log.epoch_ns(span.end_ns) - event.end_ns()) < 1e6


# ---------------------------------------------------------------- session

# PHASE A seconds of each batch: the slow ones end after the batch before
# has computed, so the compute thread waits for them
LOAD_S = [0.01, 0.01, 0.2, 0.01, 0.2, 0.01]
COMPUTE_S = 0.06


@pytest.fixture
def session_log(tmp_path, monkeypatch):
    """The span log of a session of one read a batch, with PHASE A and the
    compute replaced by sleeps."""
    from poreplex_torch.pipeline.session import ProcessingSession
    ids = ['read-{}'.format(i) for i in range(len(LOAD_S))]

    def fake_load(self, files):
        time.sleep(LOAD_S[ids.index(files[0][1])])
        return files

    def fake_analyze(self, files):
        time.sleep(COMPUTE_S)
        return [{'filename': name, 'read_id': read_id, 'status': 'okay'}
                for name, read_id in files], {}
    monkeypatch.setattr(ProcessingSession, 'load_batch', fake_load)
    monkeypatch.setattr(ProcessingSession, 'analyze_batch', fake_analyze)
    config = build_config(str(tmp_path), str(tmp_path), device='cpu',
                          batch_chunk_size=1, quiet=True)
    source = MemorySource([types.SimpleNamespace(read_id=i) for i in ids])
    with GLOBAL_TIMER.recording() as log:
        assert ProcessingSession.run(config, LOGGER, source) is not None
    return log


def test_session_analyzes_each_batch_once(session_log):
    computes = [s for s in session_log.spans if s.name == 'S:analyze_batch']
    assert [s.batch for s in computes] == list(range(len(LOAD_S)))
    assert len({s.thread for s in computes}) == 1
    assert all(s.kind == 'timed' and s.parent is None for s in computes)
    # each batch's compute counts its thread CPU once, under its batch id
    cpu = [(batch, n) for name, n, _, _, _, batch in session_log.counts
           if name == 'S:analyze_batch/cpu_ns']
    assert [batch for batch, _ in cpu] == list(range(len(LOAD_S)))
    for (_, n), span in zip(cpu, computes):
        assert 0 <= n <= span.end_ns - span.start_ns + 1e6


def test_session_idle_spans_tile_the_gaps_between_batches(session_log):
    computes = sorted((s for s in session_log.spans
                       if s.name == 'S:analyze_batch'),
                      key=lambda s: s.start_ns)
    waits = [s for s in session_log.spans if s.name.startswith('W:')]
    assert {s.name for s in waits} == {'W:compute_waits_load',
                                       'W:compute_handoff'}
    assert all(s.kind == 'interval' for s in waits)
    # the first batch has neither; every later one a hand-off, and a wait
    # for its PHASE A where that ended after the batch before computed
    handoffs = [s.batch for s in waits if s.name == 'W:compute_handoff']
    assert handoffs == list(range(1, len(LOAD_S)))
    loads = [s.batch for s in waits if s.name == 'W:compute_waits_load']
    assert {2, 4} <= set(loads) and 0 not in loads
    for w in waits:
        before, after = computes[w.batch - 1], computes[w.batch]
        assert before.end_ns - CLOCK_NS <= w.start_ns <= w.end_ns <= \
            after.start_ns + CLOCK_NS
        for c in computes:
            assert w.end_ns <= c.start_ns + CLOCK_NS or \
                w.start_ns >= c.end_ns - CLOCK_NS
    idle = sum(b.start_ns - a.end_ns for a, b in zip(computes, computes[1:]))
    assert abs(sum(w.end_ns - w.start_ns for w in waits) - idle) < 1e6
    # the slow loads are waited for, most of their time
    slow = sum(s.end_ns - s.start_ns for s in waits
               if s.name == 'W:compute_waits_load')
    assert slow > 0.15e9
