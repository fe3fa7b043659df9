"""A run of a cell whose configuration asks for ``ranks``: D processes,
one card each, over one run's reads, as a host with D cards runs
``poreplex-torch --num-nodes D --node-rank k --coordinator HOST:PORT``.

The parent builds the kernels once, then starts the D rank processes
(``python3 -m benchmark.harness.ranks``, from the checkout's root). Rank k
sees only the k-th card of the parent's visible list through
``CUDA_VISIBLE_DEVICES``, and runs with ``OMP_NUM_THREADS`` set to the
host's usable cores over D. Each rank makes its own pool and warms up
with a one-batch session of its own, outside any process group, then
reports that it is ready and waits; once every rank is ready the parent
opens all the windows at once. A rank's window is
``commandline.main`` with ``--num-nodes D --node-rank k --coordinator
127.0.0.1:<port>`` over a ``PacedSource`` of rank k, writing its own output
directory; at its end the ranks sum their final counts by gloo. Each
rank writes a report (a pickle in its work directory) and the parent
judges every rank's outputs together against the reference.

No run hangs. A rank that is interrupted never reaches the merge, and the
others would wait there for gloo's 30 minutes, so the parent ends every
rank still running ``seconds + grace + margin`` after the windows opened.
A rank that left no report has every read it was served counted as
failed; one ended inside the merge reported its reads before it.

Control lines, rank to parent on the rank's standard output: ``ready``,
``listed <k>`` once file k is listed, ``done``; the parent answers
``go`` on its standard input. What the program prints goes to the rank's
log (standard error).
"""

import argparse
import collections
import gc
import math
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types

from .source import FixedSource, PacedSource

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# seconds past a rank's own watchdog (``seconds + grace`` after its
# window opened) in which an interrupted session returns and the ranks
# waiting for it in the merge fail and write their reports
MARGIN = 30
# seconds from the ranks' start in which each must make its pool, warm
# up and report ready
READY_SECONDS = 600
# seconds between the parent's SIGTERM to a rank and its SIGKILL
TERM_SECONDS = 5
# lines of a failed rank's log copied to the parent's standard error
LOG_LINES = 40


class MergeRecorder:
    """Wraps the port's ``distributed.merge_final_counts`` for the window:
    the rank's own counts before the merge and, where the merge returns,
    the merged counts. ``before`` runs once the rank's reads are all
    processed, before the collective."""

    def __init__(self, before=None):
        self.own = self.merged = None
        self.before = before
        self._module = self._merge = None

    def __enter__(self):
        from poreplex_torch.parallel import distributed
        self._module, merge = distributed, distributed.merge_final_counts
        self._merge = merge

        def recording_merge(tracker):
            self.own = dict(tracker.counts)
            if self.before is not None:
                self.before()
            self.merged = dict(merge(tracker))
            return self.merged
        distributed.merge_final_counts = recording_merge
        return self

    def __exit__(self, *exc):
        self._module.merge_final_counts = self._merge


def merged_counts_differ(own_counts, merged):
    """Cells of rank 0's merged counts that differ from the sum of every
    rank's own counts; every cell of the sum (at least 1) where a rank
    recorded no counts or rank 0 no merge."""
    total = collections.Counter()
    for own in own_counts:
        for key, count in (own or {}).items():
            total[key] += count
    if merged is None or any(own is None for own in own_counts):
        return max(1, len(total))
    return sum(1 for key in set(total) | set(merged)
               if total.get(key, 0) != merged.get(key, 0))


def merged_run(reports, windows, work, stage1_frames, completed_frames,
               peak_fp32):
    """The run that the per-layer readers see, from every rank's report
    (``timer`` {name: (seconds, count)}, ``batches``, ``device_spans``,
    ``host_spans``; None for a rank that left none) and window ((main
    entered, returned) on the host's clock): the window from the first
    rank's entry to the last rank's return; timers and batches summed, so
    a per-batch metric is the mean rank's; the device spans of every
    card together; ``busy_s`` the mean card's within the window; the
    peak that of every card."""
    from . import trace as tr
    t0 = min(w[0] for w in windows)
    t1 = max(w[1] for w in windows)
    timer, batches = {}, 0
    spans, busy, host_spans = [], [], None
    for k, rep in enumerate(reports):
        if rep is None:
            continue
        for name, (seconds, count) in rep['timer'].items():
            s, c = timer.get(name, (0.0, 0))
            timer[name] = (s + seconds, c + count)
        batches += rep['batches']
        if rep.get('device_spans') is not None:
            spans.extend(rep['device_spans'])
            busy.append(tr.busy_seconds(rep['device_spans'], t0, t1))
        if k == 0:
            host_spans = rep.get('host_spans')
    traced = bool(busy)
    return types.SimpleNamespace(
        timer=timer, batches=batches, window_s=t1 - t0,
        device_spans=sorted(spans) if traced else None,
        host_spans=host_spans,
        busy_s=sum(busy) / len(busy) if traced else None,
        work=work, stage1_frames=stage1_frames,
        completed_frames=completed_frames,
        peak_fp32=peak_fp32 * len(reports), rank_windows=list(windows))


def usable_cores():
    return len(os.sched_getaffinity(0))


def visible_cards(ranks):
    """The cards of the ranks, as ``CUDA_VISIBLE_DEVICES`` names them in
    this process, else by index; NoCards where it names fewer than
    ``ranks``, since two ranks never share a card."""
    names = [n.strip() for n in
             os.environ.get('CUDA_VISIBLE_DEVICES', '').split(',')
             if n.strip()]
    if not names:
        return [str(k) for k in range(ranks)]
    if len(names) < ranks:
        raise NoCards('the cell needs {} CUDA cards, {} visible'.format(
            ranks, len(names)))
    return names[:ranks]


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def rank_command(args):
    """The command line of one rank process."""
    return [sys.executable, '-m', 'benchmark.harness.ranks'] + args


class Rank:
    """One rank process seen from the parent: its control lines as they
    come, its log, and how it ended."""

    def __init__(self, k, command, env, cwd, workdir):
        self.k = k
        self.workdir = workdir
        os.makedirs(workdir)
        self.log_path = os.path.join(workdir, 'rank.log')
        self.listed = -1          # last file listed
        self.ready = threading.Event()
        self.ended_at = None      # host clock the parent saw it end
        with open(self.log_path, 'w') as log:
            self.proc = subprocess.Popen(
                command, cwd=cwd, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=log, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            line = line.strip()
            if line == 'ready':
                self.ready.set()
            elif line.startswith('listed '):
                self.listed = int(line.split()[1])

    def send(self, line):
        try:
            self.proc.stdin.write(line + '\n')
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError):
            pass

    def poll(self):
        code = self.proc.poll()
        if code is not None and self.ended_at is None:
            self.ended_at = time.perf_counter()
        return code

    def end(self):
        """Ends the process if it is still running, and waits for it."""
        if self.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(TERM_SECONDS)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.poll()
        self._reader.join(TERM_SECONDS)
        if self.proc.stdin:
            try:
                self.proc.stdin.close()
            except OSError:
                pass

    def report(self):
        """The rank's report, else its report from before the merge, else
        None."""
        for name in ('report.pkl', 'premerge.pkl'):
            path = os.path.join(self.workdir, name)
            if os.path.exists(path):
                with open(path, 'rb') as f:
                    return pickle.load(f)
        return None

    def log_tail(self):
        try:
            with open(self.log_path) as f:
                lines = f.read().splitlines()
        except OSError:
            return ''
        return '\n'.join(lines[-LOG_LINES:])


class NoCards(RuntimeError):
    """Fewer CUDA cards than the cell's ranks."""


def check_cards(needed):
    """Raises NoCards unless torch sees ``needed`` CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise NoCards('no CUDA card: the benchmark measures poreplex_torch '
                      'on CUDA cards and never on the CPU')
    if torch.cuda.device_count() < needed:
        raise NoCards('the cell needs {} CUDA cards, {} visible'.format(
            needed, torch.cuda.device_count()))


def start_ranks(ranks, args, device, tmp, threads):
    """The rank processes, rank k on the k-th visible card."""
    cards = visible_cards(ranks) if device != 'cpu' else None
    coordinator = '127.0.0.1:{}'.format(free_port())
    started = []
    for k in range(ranks):
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        if cards is not None:
            env['CUDA_VISIBLE_DEVICES'] = cards[k]
        workdir = os.path.join(tmp, 'rank{}'.format(k))
        command = rank_command(args + ['--rank', str(k), '--ranks',
                                       str(ranks), '--coordinator',
                                       coordinator, '--workdir', workdir])
        started.append(Rank(k, command, env, ROOT, workdir))
    return started


def wait_ready(ranks, seconds):
    """Waits until every rank is ready; raises if one ends first or the
    time runs out."""
    deadline = time.perf_counter() + seconds
    while not all(r.ready.is_set() for r in ranks):
        for r in ranks:
            if not r.ready.is_set() and r.poll() is not None:
                raise RuntimeError('rank {} ended before its window, code '
                                   '{}:\n{}'.format(r.k, r.proc.returncode,
                                                    r.log_tail()))
        if time.perf_counter() > deadline:
            raise RuntimeError('the ranks were not ready within {} s'
                               .format(seconds))
        time.sleep(0.05)


def wait_ended(ranks, deadline):
    """Waits until every rank has ended or the deadline has passed, then
    ends those still running. Returns the ranks that were ended."""
    while time.perf_counter() < deadline:
        if all(r.poll() is not None for r in ranks):
            break
        time.sleep(0.05)
    late = [r for r in ranks if r.poll() is None]
    for r in ranks:
        # the control lines of a rank that ended are read to the end
        r.end()
    return late


def rank_outputs(outdir, wanted, whole):
    """(summary rows, FASTQ records of ``wanted``) of one rank's output
    directory; for a rank that did not end its session (``whole``
    false), what could be read of it."""
    from . import outputs
    try:
        rows = outputs.summary_rows(outdir)
    except (OSError, IndexError, KeyError):
        if whole:
            raise
        rows = {}
    try:
        fastq = outputs.fastq_records(outdir, wanted)
    except (OSError, EOFError):
        if whole:
            raise
        fastq = {}
    return rows, fastq


def main(args, t_start):
    """``run.py``'s entry for a cell of ranks: the ranks start before this
    process imports torch, which it needs only to check the cards and to
    run the reference."""
    from benchmark import run
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          args.trace, 'cuda', args.wire_precision, None,
                          None, run.JUDGED_READS, run.LATE_SECONDS,
                          t_start)
    except NoCards as exc:
        print(exc, file=sys.stderr)
        return 2
    run.report(result)
    return 0


def run_cell(workload, seed, seconds, trace, device, wire, pool_reads,
             batch_size, judged_reads, grace, t_start, ranks=None,
             margin=None):
    """One run of a cell on ``ranks`` rank processes (the configuration's
    by default, two or more) with ``margin`` (``MARGIN`` by default);
    returns the result dict, as ``run.run_cell`` does. Off the CPU,
    NoCards where fewer than ``ranks`` cards are visible."""
    from benchmark import run
    from benchmark.harness import counts, outputs, traffic

    manifest = run.load_manifest()
    cell, entry, e2e, per_layer = run.cell_entries(manifest, workload)
    config = run.load_json(entry['file'])
    params = traffic.load(cell['traffic'])
    if pool_reads:
        params = dict(params, pool_reads=pool_reads)
    if batch_size:
        config = dict(config, batch_size=batch_size,
                      device_batch_size=batch_size)
    ranks = ranks or config['ranks']
    if ranks < 2:
        # one process joins no group and merges nothing: run.run_cell's
        raise ValueError('a run of ranks takes two or more, not {}'.format(
            ranks))
    margin = MARGIN if margin is None else margin
    cores = usable_cores()
    threads = max(1, cores // ranks)

    marks = {'imports': time.perf_counter() - t_start}
    build_s = None
    if device != 'cpu':
        from poreplex_torch.kernels import _build
        t = time.perf_counter()
        try:
            _build.build_all()
        except RuntimeError:
            # a host without the toolkit may have no card either
            check_cards(ranks)
            raise
        build_s = time.perf_counter() - t
    marks['build'] = time.perf_counter() - t_start

    args = ['--workload', workload, '--seed', str(seed), '--seconds',
            str(seconds), '--trace', str(trace), '--device', device,
            '--wire', wire, '--grace', str(grace)]
    if pool_reads:
        args += ['--pool-reads', str(pool_reads)]
    if batch_size:
        args += ['--batch-size', str(batch_size)]
    tmp = tempfile.mkdtemp(prefix='poreplex-bench-')
    procs = []
    try:
        procs = start_ranks(ranks, args, device, tmp, threads)
        if device != 'cpu':
            # torch's import overlaps the ranks' set-up
            check_cards(ranks)
        # the parent's pool, for the judged reads and their frames, is
        # made while the ranks make theirs
        pool = traffic.make_pool(params)
        marks['pool'] = time.perf_counter() - t_start
        wait_ready(procs, READY_SECONDS)
        t_go = time.perf_counter()
        for r in procs:
            r.send('go')
        deadline = t_go + seconds + grace + margin
        late = wait_ended(procs, deadline)
        reports = [r.report() for r in procs]
        found = run.forbidden_modules()
        for rep in reports:
            found += rep.get('forbidden', []) if rep else []
        if found:
            raise RuntimeError('modules of JAX or the JAX package were '
                               'loaded: {}'.format(', '.join(sorted(set(
                                   found)))))

        batch = config['batch_size']
        served, completed, per_rank = {}, [], []
        for r, rep in zip(procs, reports):
            if rep is None:
                # no report: every read it was served counts as failed
                src = PacedSource(pool, seed, batch, seconds, rank=r.k,
                                  ranks=ranks)
                mine, done = src.served_through(r.listed), []
                t0_k, t1_k = t_go, r.ended_at
            else:
                mine = rep['served']
                done = [rid for rid in mine if rid in rep['status'] and
                        rep['status'][rid] not in outputs.FAILED_STATUSES]
                t0_k = rep['t0']
                t1_k = rep['t1'] if rep.get('t1') else r.ended_at
            served.update(mine)
            completed += done
            per_rank.append(dict(t0=t0_k, t1=t1_k, reads=len(mine),
                                 completed=len(done)))
        t0 = min(p['t0'] for p in per_rank)
        t1 = max(p['t1'] for p in per_rank)
        window_s = t1 - t0
        setup_s = max(p['t0'] for p in per_rank) - t_start
        attempted = len(served)
        failed = attempted - len(completed)
        memory_peak = max((rep['memory_peak'] for rep in reports if rep),
                          default=0)
        named = [rep['device_name'] for rep in reports if rep]
        kind = named[0] if named else 'unknown'

        stride = config['rough_signal_stride']

        def frames(rid):
            return min(pool[served[rid]].duration // stride,
                       config['segmentation_frames'])

        metrics = {}
        values = {'reads_per_s': len(completed) / window_s,
                  'setup_s': setup_s}
        result_device = {'platform': 'gpu' if device != 'cpu' else 'cpu',
                         'kind': kind, 'count': ranks,
                         'memory_peak_bytes': memory_peak}
        breakdown = None
        if trace:
            from benchmark.harness import trace as tr
            merged = merged_run(
                reports, [(p['t0'], p['t1']) for p in per_rank],
                run.stage1_work(config),
                [frames(rid) for rid in served],
                [frames(rid) for rid in completed], counts.PEAK_FP32)
            for m in per_layer:
                value = run.read_metric(m['name'], merged)
                if value is not None:
                    metrics[m['name']] = {'value': value, 'unit': m['unit']}
            result_device.update(busy_s=merged.busy_s, window_s=window_s)
            first = reports[0]
            if first and first.get('device_spans') is not None:
                # the breakdown is rank 0's card
                breakdown = {
                    'device_ops': tr.device_ops(first['device_spans']),
                    'idle_gaps': tr.idle_gaps(first['device_spans'],
                                              first['host_spans'], t0, t1)}
        else:
            for m in e2e:
                metrics[m['name']] = {'value': values[m['name']],
                                      'unit': m['unit']}

        # every rank has ended; the reference runs in the parent
        gc.collect()
        sample = run.judged_indices(pool, seed, judged_reads,
                                    run.JUDGED_FUSED)
        judged = {rid: idx for rid, idx in served.items() if idx in sample}
        t = time.perf_counter()
        expected = run.expected_outputs(config, pool, sample, device)
        rows, fastq, with_row = {}, {}, collections.Counter()
        for r, rep in zip(procs, reports):
            whole = rep is not None and rep.get('t1') is not None and \
                r not in late
            got_rows, got_fastq = rank_outputs(
                os.path.join(r.workdir, 'out'), set(judged), whole)
            for rid in got_rows:
                with_row[rid] += 1
            rows.update(got_rows)
            fastq.update(got_fastq)
        numbers, fields, gaps = outputs.compare(judged, rows, fastq,
                                                expected)
        reference_s = time.perf_counter() - t
        duplicates = sum(1 for rid in judged if with_row[rid] > 1)
        differ = merged_counts_differ(
            [rep.get('own_counts') if rep else None for rep in reports],
            reports[0].get('merged_counts') if reports[0] else None)
        logs = {r.k: r.log_tail() for r, rep in zip(procs, reports)
                if rep is None or rep.get('error') or r in late}
    finally:
        for r in procs:
            r.end()
        shutil.rmtree(tmp, ignore_errors=True)

    for k, tail in sorted(logs.items()):
        print('rank {} log:\n{}'.format(k, tail), file=sys.stderr)
    checks = run.output_checks(numbers, config, params)
    checks['duplicate_rows'] = {'value': duplicates, 'limit': 0}
    checks['merged_counts_differ'] = {'value': differ, 'limit': 0}
    result = {'correct': run.judge(checks), 'attempted': attempted,
              'failed': failed, 'metrics': metrics,
              'device': result_device}
    if breakdown is not None:
        result['breakdown'] = breakdown
    statuses = collections.Counter()
    for rep in reports:
        if rep:
            statuses.update(rep['status'][rid] for rid in rep['served']
                            if rid in rep['status'])
    result['info'] = {
        'seed': seed, 'window_s': window_s, 'ranks': [
            dict(rank=k, reads=p['reads'], completed=p['completed'],
                 window=[p['t0'] - t0, p['t1'] - t0],
                 code=r.proc.returncode, ended_by_parent=r in late,
                 error=rep.get('error') if rep else 'no report',
                 setup_marks=rep.get('setup_marks') if rep else None,
                 batches=rep['batches'] if rep else None,
                 memory_peak=rep['memory_peak'] if rep else None)
            for k, (r, rep, p) in enumerate(zip(procs, reports, per_rank))],
        'deadline_s': seconds + grace + margin,
        'usable_cores': cores, 'rank_omp_threads': threads,
        'build_s': build_s, 'reference_s': reference_s,
        'judged_pool_reads': len(sample), 'differing_fields': fields,
        'differing_pool_reads': numbers['differing'],
        'dwell_pairs': sorted(gaps, key=run.dwell_gap_order)[:12],
        'statuses': dict(statuses), 'wire_precision': wire,
        'setup_marks': marks,
        'launches': dict(sum((collections.Counter(rep['launches'])
                              for rep in reports if rep),
                             collections.Counter())),
        'power_limit': run.card_power_limit() if device != 'cpu' else None}
    result['checks'] = checks
    return result


# ---------------------------------------------------------------------------
# the rank process


def parse_rank_args(argv):
    parser = argparse.ArgumentParser(description='one rank of a run')
    for name in ('--workload', '--device', '--wire', '--coordinator',
                 '--workdir'):
        parser.add_argument(name, required=True)
    for name in ('--seed', '--seconds', '--trace', '--grace', '--rank',
                 '--ranks'):
        parser.add_argument(name, required=True, type=int)
    parser.add_argument('--pool-reads', type=int, default=None)
    parser.add_argument('--batch-size', type=int, default=None)
    return parser.parse_args(argv)


def write_report(path, report):
    partial = path + '.partial'
    with open(partial, 'wb') as f:
        pickle.dump(report, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(partial, path)


def rank_main(argv=None):
    """One rank: set-up, the word to go, the window, the report."""
    t_start = time.perf_counter()
    args = parse_rank_args(sys.argv[1:] if argv is None else argv)
    # the control lines keep the standard output; what the program
    # prints goes to the rank's log
    control = os.fdopen(os.dup(1), 'w', buffering=1)
    os.dup2(2, 1)
    lock = threading.Lock()

    def say(line):
        with lock:
            control.write(line + '\n')
            control.flush()

    import torch
    from benchmark import run
    from benchmark.harness import outputs, traffic
    from poreplex_torch import kernels
    from poreplex_torch.utils import GLOBAL_TIMER

    cell, entry, _, _ = run.cell_entries(run.load_manifest(), args.workload)
    config = run.load_json(entry['file'])
    params = traffic.load(cell['traffic'])
    if args.pool_reads:
        params = dict(params, pool_reads=args.pool_reads)
    if args.batch_size:
        config = dict(config, batch_size=args.batch_size,
                      device_batch_size=args.batch_size)
    batch, device = config['batch_size'], args.device
    marks = {'imports': time.perf_counter() - t_start}
    if device != 'cpu':
        from poreplex_torch.kernels import _build
        _build.build_all()
    pool = traffic.make_pool(params)
    marks['pool'] = time.perf_counter() - t_start
    indir = os.path.join(args.workdir, 'in')
    os.makedirs(indir)
    warm_out = os.path.join(args.workdir, 'warmup')
    run.run_session(
        run.session_argv(config, indir, warm_out, device, args.wire),
        FixedSource(pool, run.warmup_indices(pool, min(batch, len(pool)))))
    shutil.rmtree(warm_out)
    marks['warmup'] = time.perf_counter() - t_start

    say('ready')
    if sys.stdin.readline().strip() != 'go':
        return 1

    GLOBAL_TIMER.totals.clear()
    GLOBAL_TIMER.counts.clear()
    kernels.reset_launches()
    if device != 'cpu':
        torch.cuda.reset_peak_memory_stats()
    source = PacedSource(pool, args.seed, batch, args.seconds,
                         rank=args.rank, ranks=args.ranks,
                         on_listed=lambda k: say('listed {}'.format(k)))
    outdir = os.path.join(args.workdir, 'out')
    argv = run.session_argv(config, indir, outdir, device, args.wire) + [
        '--num-nodes', str(args.ranks), '--node-rank', str(args.rank),
        '--coordinator', args.coordinator]
    report = {'setup_marks': marks, 'error': None, 't1': None}

    def premerge():
        report.update(t0=source.deadline - source.seconds,
                      served=dict(source.served),
                      status=dict(results.status), own_counts=merge.own,
                      batches=math.ceil(len(source.served) / batch),
                      timer={}, launches={}, memory_peak=0,
                      device_name=device_name(device), forbidden=[])
        write_report(os.path.join(args.workdir, 'premerge.pkl'), report)

    device_spans = host_spans = None
    with outputs.ResultRecorder() as results, \
            MergeRecorder(premerge) as merge:
        try:
            if args.trace:
                from benchmark.harness.trace import DeviceTrace, SpanRecorder
                with SpanRecorder(GLOBAL_TIMER) as rec, \
                        DeviceTrace() as dev:
                    t0, t1 = run.run_session(argv, source, args.grace)
                device_spans, host_spans = dev.spans, rec.spans
            else:
                t0, t1 = run.run_session(argv, source, args.grace)
        except (Exception, KeyboardInterrupt, SystemExit) as exc:
            # the rank reports what it did all the same
            t0 = (source.deadline - source.seconds if source.deadline
                  else time.perf_counter())
            t1 = None
            report['error'] = repr(exc)
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device != 'cpu' else 0)
    names = {}
    if device_spans is not None:
        # one string a kernel name keeps the pickle small
        device_spans = [(s, e, names.setdefault(n, n))
                        for s, e, n in device_spans]
    report.update(
        t0=t0, t1=t1, served=dict(source.served),
        status=dict(results.status), own_counts=merge.own,
        merged_counts=merge.merged if args.rank == 0 else None,
        batches=math.ceil(len(source.served) / batch),
        timer={name: (GLOBAL_TIMER.totals[name], GLOBAL_TIMER.counts[name])
               for name in list(GLOBAL_TIMER.totals)},
        launches=dict(kernels.launches), memory_peak=memory_peak,
        device_name=device_name(device), forbidden=run.forbidden_modules(),
        device_spans=device_spans,
        host_spans=host_spans if args.rank == 0 else None)
    write_report(os.path.join(args.workdir, 'report.pkl'), report)
    say('done')
    return 0 if report['error'] is None else 1


def device_name(device):
    import torch
    return torch.cuda.get_device_name(0) if device != 'cpu' else 'cpu'


if __name__ == '__main__':
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(rank_main())
