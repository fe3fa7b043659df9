#!/usr/bin/env python3
"""One run of one benchmark cell of poreplex_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run is one process on one CUDA card. Set-up: the cell's configuration
and traffic files by name (``BENCHMARK.json``), the kernels from the
port's build cache (``build/poreplex_torch_kernels/`` in the checkout,
built there by the first run), the traffic's pool of distinct reads,
and one warm-up session of one batch. The window: one
``poreplex_torch.commandline.main`` session over the pool, served in the
seed's order (``harness/source.py``), with the configuration's options,
writing under TMPDIR; its listing ends after ``--seconds``. Then the
outputs of a seeded sample of the pool's reads are held against the
plain reference (``reference/``). The last line of standard output is the result as one
JSON object; with ``--trace 1`` its metrics are the cell's per-layer ones,
read from the program's stage spans and a device trace of the window.

With no CUDA card the run fails: nothing is measured on the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'poreplex_tpu')
# pool reads whose outputs the reference recomputes and judges, every
# served instance of each; the longest transcript, the longest tail and
# the first reads of two molecules are always among them
JUDGED_READS = 64
JUDGED_FUSED = 8
# seconds past the listing's end after which a session that has not
# returned is interrupted: its unfinished reads count as failed
LATE_SECONDS = 60


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', required=True, type=int)
    parser.add_argument('--seconds', required=True, type=int)
    parser.add_argument('--trace', default=0, type=int, choices=(0, 1))
    # the control of the output check, never a benchmark run: the
    # program's own lower-precision signal transport
    parser.add_argument('--wire-precision', default='exact',
                        choices=('exact', 'fast'))
    return parser.parse_args(argv)


def load_manifest():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def cell_entries(manifest, workload):
    """(the workload's entry, its configuration's entry, the metric
    entries this cell reports with --trace 0 and with --trace 1)."""
    cells = {w['name']: w for w in manifest['workloads']}
    if workload not in cells:
        raise SystemExit('unknown workload {!r}; the cells are {}'.format(
            workload, sorted(cells)))
    cell = cells[workload]
    config = {c['name']: c for c in manifest['configs']}[cell['config']]

    def ours(metrics):
        return [m for m in metrics
                if workload in m.get('workloads', [workload])]
    return cell, config, ours(manifest['end_to_end']), \
        ours(manifest['per_layer'])


def load_json(relpath):
    with open(os.path.join(ROOT, relpath)) as f:
        return json.load(f)


def analyses(config):
    """The configuration's analyses with its barcode filter."""
    return dict(config['analyses'],
                barcoding_quality_filter=config['barcoding_quality_filter'])


def session_argv(config, indir, outdir, device, wire):
    """The CLI arguments of a session with the configuration's options."""
    a = analyses(config)
    argv = ['-i', indir, '-o', outdir, '-y', '-q', '--mesh-shape', '1',
            '--batch-size', str(config['batch_size']),
            '--device-batch-size', str(config['device_batch_size']),
            '-p', str(config['ingest_processes'])]
    if a['barcoding']:
        argv += ['--barcoding', '--barcoding-quality-filter',
                 str(a['barcoding_quality_filter'])]
    if a['polya']:
        argv.append('--polya')
    if a['filter_chimera']:
        argv.append('--filter-chimera')
    if a['trim_adapter']:
        argv.append('--trim-adapter')
    argv += ['--minimum-length', str(a['minimum_length'])]
    if wire != 'exact':
        argv += ['--wire-precision', wire]
    if device == 'cpu':
        argv.append('--cpu')
    return argv


def warmup_indices(pool, count):
    """``count`` pool reads spread evenly over the order of their tail
    lengths, so the warm-up batch meets every poly(A) window bucket."""
    order = sorted(range(len(pool)), key=lambda i: pool[i].polya_len)
    step = len(order) / count
    return [order[int(k * step)] for k in range(count)]


def judged_indices(pool, seed, count, fused):
    """The seed's sample of pool reads to judge: the longest transcript,
    the longest tail, the first ``fused`` reads of two molecules, then
    reads drawn from the seed."""
    import numpy as np
    from benchmark.harness.traffic import seed_sequence
    picks = [max(range(len(pool)), key=lambda i: pool[i].transcript_len),
             max(range(len(pool)), key=lambda i: pool[i].polya_len)]
    picks += [i for i, r in enumerate(pool) if r.two_molecules][:fused]
    rng = np.random.default_rng(seed_sequence(seed, 2))
    for i in rng.permutation(len(pool)):
        if len(set(picks)) >= min(count, len(pool)):
            break
        picks.append(int(i))
    return sorted(set(picks))


def dwell_gap_order(pair):
    """Widest first; a tail on one side only before any gap."""
    _, a, b = pair
    return -abs(float(a) - float(b)) if a and b else -float('inf')


def card_power_limit():
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def forbidden_modules():
    return sorted({name.split('.')[0] for name in list(sys.modules)} &
                  set(FORBIDDEN))


def read_metric(name, run):
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'bench_metric_' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def expected_outputs(config, pool, sample, device,
                     polya_precision='float32'):
    """{pool index: (summary row fields, FASTQ record)} of the sampled
    pool reads by the plain reference."""
    from benchmark.harness.source import READ_META
    from benchmark.reference.pipeline import Reference
    reference = Reference(
        os.path.join(HERE, 'configs', config['reference_preset']),
        analyses(config), device, polya_precision=polya_precision)
    got = reference.run([pool[i] for i in sample], READ_META)
    return {idx: got[k] for k, idx in enumerate(sample)}


def stage1_work(config):
    from benchmark.harness.counts import Stage1Work
    return Stage1Work(
        head_frames=config['scaler_head_frames'],
        scaler_hidden=config['scaler_lstm_hidden'],
        seg_states=config['segmentation_states'], seg_comp=1,
        demux_frames=config['demux_window_frames'],
        demux_hidden=config['demux_bilstm_hidden'],
        last_hidden=config['demux_lstm_hidden'],
        barcoding=config['analyses']['barcoding'])


def run_session(argv, source, grace=LATE_SECONDS):
    """commandline.main over ``source``: (the host's clock when main was
    entered, and when it returned). A session still running ``grace``
    seconds past the source's deadline is interrupted as Ctrl-C would,
    and returns with what it finished."""
    import torch
    from poreplex_torch import commandline
    args = commandline.parse_args(argv)
    t0 = time.perf_counter()
    source.start()
    watchdog = threading.Timer(source.seconds + grace,
                               signal.raise_signal, (signal.SIGINT,))
    watchdog.start()
    try:
        commandline.main(args, source=source)
    finally:
        watchdog.cancel()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return t0, time.perf_counter()


def run_cell(workload, seed, seconds, trace=0, device='cuda', wire='exact',
             pool_reads=None, batch_size=None, judged_reads=JUDGED_READS,
             grace=LATE_SECONDS, t_start=T_START):
    """One run of the cell; returns the result dict. ``device='cpu'`` and
    the size overrides are for the CPU tests only."""
    import torch
    from benchmark.harness import counts, outputs, traffic
    from benchmark.harness.source import FixedSource, PacedSource
    from poreplex_torch import kernels
    from poreplex_torch.utils import GLOBAL_TIMER

    manifest = load_manifest()
    cell, entry, e2e, per_layer = cell_entries(manifest, workload)
    config = load_json(entry['file'])
    params = traffic.load(cell['traffic'])
    if pool_reads:
        params = dict(params, pool_reads=pool_reads)
    if batch_size:
        config = dict(config, batch_size=batch_size,
                      device_batch_size=batch_size)
    batch = config['batch_size']

    marks = {'imports': time.perf_counter() - t_start}
    build_s = None
    if device != 'cpu':
        from poreplex_torch.kernels import _build
        t = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t

    marks['build'] = time.perf_counter() - t_start
    pool = traffic.make_pool(params)
    marks['pool'] = time.perf_counter() - t_start
    tmp = tempfile.mkdtemp(prefix='poreplex-bench-')
    try:
        indir = os.path.join(tmp, 'in')
        os.makedirs(indir)
        warm_out = os.path.join(tmp, 'warmup')
        run_session(session_argv(config, indir, warm_out, device, wire),
                    FixedSource(pool, warmup_indices(pool, min(batch,
                                                               len(pool)))))
        shutil.rmtree(warm_out)
        setup_s = time.perf_counter() - t_start

        GLOBAL_TIMER.totals.clear()
        GLOBAL_TIMER.counts.clear()
        kernels.reset_launches()
        if device != 'cpu':
            torch.cuda.reset_peak_memory_stats()
        source = PacedSource(pool, seed, batch, seconds)
        outdir = os.path.join(tmp, 'out')
        argv = session_argv(config, indir, outdir, device, wire)
        device_spans = host_spans = None
        cpu0 = time.process_time()
        with outputs.ResultRecorder() as results:
            if trace:
                from benchmark.harness.trace import DeviceTrace, SpanRecorder
                with SpanRecorder(GLOBAL_TIMER) as rec, DeviceTrace() as dev:
                    t0, t1 = run_session(argv, source, grace)
                device_spans, host_spans = dev.spans, rec.spans
            else:
                t0, t1 = run_session(argv, source, grace)
        window_s = t1 - t0
        window_cpu_s = time.process_time() - cpu0
        memory_peak = (torch.cuda.max_memory_allocated()
                       if device != 'cpu' else 0)
        timer = {name: (GLOBAL_TIMER.totals[name], GLOBAL_TIMER.counts[name])
                 for name in list(GLOBAL_TIMER.totals)}
        launches = dict(kernels.launches)
        found = forbidden_modules()
        if found:
            raise RuntimeError('modules of JAX or the JAX package were '
                               'loaded: {}'.format(', '.join(found)))

        rows = outputs.summary_rows(outdir)
        served = source.served
        attempted = len(served)
        completed = results.completed(served)
        failed = attempted - len(completed)

        stride = config['rough_signal_stride']

        def frames(rid):
            return min(pool[served[rid]].duration // stride,
                       config['segmentation_frames'])

        metrics = {}
        values = {'reads_per_s': len(completed) / window_s,
                  'setup_s': setup_s}
        result_device = {
            'platform': 'gpu' if device != 'cpu' else 'cpu',
            'kind': (torch.cuda.get_device_name(0) if device != 'cpu'
                     else 'cpu'),
            'count': 1, 'memory_peak_bytes': memory_peak}
        breakdown = None
        if trace:
            from benchmark.harness import trace as tr
            busy_s = tr.busy_seconds(device_spans, t0, t1)
            run = types.SimpleNamespace(
                timer=timer, batches=sum(1 for b in source.batches if b),
                window_s=window_s, device_spans=device_spans,
                host_spans=host_spans, busy_s=busy_s,
                work=stage1_work(config),
                stage1_frames=[frames(rid) for rid in served],
                completed_frames=[frames(rid) for rid in completed],
                peak_fp32=counts.PEAK_FP32)
            for m in per_layer:
                value = read_metric(m['name'], run)
                if value is not None:
                    metrics[m['name']] = {'value': value, 'unit': m['unit']}
            result_device.update(busy_s=busy_s, window_s=window_s)
            breakdown = {
                'device_ops': tr.device_ops(device_spans),
                'idle_gaps': tr.idle_gaps(device_spans, host_spans, t0, t1)}
        else:
            for m in e2e:
                metrics[m['name']] = {'value': values[m['name']],
                                      'unit': m['unit']}

        # the program's state is gone; the reference runs in what is left
        gc.collect()
        if device != 'cpu':
            torch.cuda.empty_cache()
        sample = judged_indices(pool, seed, judged_reads, JUDGED_FUSED)
        judged = {rid: idx for rid, idx in served.items() if idx in sample}
        t = time.perf_counter()
        expected = expected_outputs(config, pool, sample, device)
        fastq = outputs.fastq_records(outdir, set(judged))
        numbers, fields, gaps = outputs.compare(judged, rows, fastq,
                                                expected)
        reference_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n = numbers['judged']
    checks = {
        'judged_reads': {'value': n, 'limit': 1},
        'missing_rows': {'value': numbers['missing'], 'limit': 0},
        'rows_differ_share': {
            'value': numbers['differ'] / n if n else 1.0,
            'limit': outputs.ROWS_DIFFER_LIMIT},
    }
    if config['analyses']['polya']:
        checks['dwell_gap_s'] = {'value': numbers['dwell_gap'],
                                 'limit': params['dwell_gap_limit_s']}
    # judged_reads is a least number, the others most numbers
    correct = n >= 1 and all(c['value'] <= c['limit']
                             for k, c in checks.items()
                             if k != 'judged_reads')
    result = {'correct': correct, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': result_device}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['info'] = {
        'seed': seed, 'window_s': window_s, 'batches': len(source.batches),
        'build_s': build_s, 'reference_s': reference_s,
        'judged_pool_reads': len(sample), 'differing_fields': fields,
        'differing_pool_reads': numbers['differing'],
        'dwell_pairs': sorted(gaps, key=dwell_gap_order)[:12],
        'statuses': dict(collections.Counter(results.status.values())),
        'launches': launches, 'wire_precision': wire,
        'setup_marks': marks, 'window_cpu_s': window_cpu_s,
        'power_limit': card_power_limit() if device != 'cpu' else None}
    result['checks'] = checks
    return result


def report(result):
    """The compared numbers on standard error, then the result line."""
    for name, check in result['checks'].items():
        print('check {}: {} (limit {})'.format(name, check['value'],
                                               check['limit']),
              file=sys.stderr)
    print('correct: {}'.format(result['correct']), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          os.path.join(ROOT, 'build', 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR',
                          os.path.join(ROOT, 'build', 'triton'))
    manifest = load_manifest()
    cell, _, _, _ = cell_entries(manifest, args.workload)
    import torch
    if not torch.cuda.is_available():
        print('no CUDA card: the benchmark measures poreplex_torch on a '
              'CUDA card and never on the CPU', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell['chips']:
        print('the cell needs {} CUDA cards, {} visible'.format(
            cell['chips'], torch.cuda.device_count()), file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      wire=args.wire_precision)
    report(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
