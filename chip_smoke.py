#!/usr/bin/env python3
"""Smoke run of poreplex_torch on one CUDA card.

    python3 chip_smoke.py            (from the repository root)

1. builds the CUDA kernels from poreplex_torch/csrc/ (one nvcc per source,
   all at once) and prints the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes stage 1 gives it (B = 256 reads, scaler T = 2000, demux T = 300,
   segmentation T = 6666): LSTM outputs within 5e-5 absolute, Viterbi
   extents exactly equal and logp within 1e-5 relative; times the kernel,
   the plain version and, where one PyTorch call computes the same
   function, that call (torch.nn.LSTM with the converted weights);
3. simulates 512 reads (basecalls included, transcripts of 9,000 to
   90,000 raw samples) from a fixed seed and runs
   them through BatchAnalyzer on the card with barcoding (quality filter
   phred 7) and adapter trimming on, writes FASTQ and
   sequencing_summary.txt, checks the
   reports, and holds the first reads' stage-1 outputs against the same
   engine on the CPU; every kernel must have been launched on this path;
4. prints a JSON line of the kernels, then {"ok": true, ...} last.

Any failure raises and exits non-zero before the last line is printed.
"""

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20241016
DEVICE = 'cuda'
N_READS = 512
BATCH = 256
TRANSCRIPT_SAMPLES = (9000, 90001)
# the simulator's barcode signatures are synthetic, and the trained demux
# network scores them between about 0.3 and 0.97: below the default
# quality filter (phred 18, a score of 0.98), so the smoke assigns
# barcodes from phred 7 (a score of 0.70)
BARCODE_PHRED = 7
LSTM_ATOL = 5e-5
LOGP_RTOL = 1e-5
# published peaks of an H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# gate math per hidden unit and step: three sigmoids, two expm1 tanhs and
# the cell update, counted as elementwise operations
GATE_OPS = 28


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops, nbytes):
    """Least time (ms) the card could take: the larger of operations over
    the fp32 peak and bytes over the memory rate."""
    ops_ms = flops / PEAK_FP32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else \
        (bytes_ms, 'bytes')


def lstm_flops(batch, seqlen, inputs, hidden, matrices):
    """Per row and step: the input projection, ``matrices`` [H, 4H]
    products, the pre-activation adds and the gate math."""
    g = 4 * hidden
    return batch * seqlen * (2 * inputs * g + matrices * 2 * hidden * g +
                             matrices * g + hidden * GATE_OPS)


def torch_lstm(layers, bidirectional=False):
    """torch.nn.LSTM carrying the Keras weights (gate order [i, f, c, o] is
    torch's [i, f, g, o]); the yardstick only."""
    first = layers[0][0]
    hidden = first['recurrent'].shape[0]
    net = torch.nn.LSTM(first['kernel'].shape[0], hidden,
                        num_layers=len(layers), batch_first=True,
                        bidirectional=bidirectional).to(DEVICE)
    with torch.no_grad():
        for k, dirs in enumerate(layers):
            for d, p in enumerate(dirs):
                sfx = '_l{}{}'.format(k, '_reverse' if d else '')
                getattr(net, 'weight_ih' + sfx).copy_(p['kernel'].t())
                getattr(net, 'weight_hh' + sfx).copy_(p['recurrent'].t())
                getattr(net, 'bias_ih' + sfx).copy_(p['bias'])
                getattr(net, 'bias_hh' + sfx).zero_()
    return net


def check_lstms(engine, rng):
    from poreplex_torch.kernels import lstm as klstm
    from poreplex_torch.ops import rnn
    scaler, demux = engine.scaler, engine.demux
    dev = DEVICE
    rows = []

    heads = torch.as_tensor(rng.normal(90, 12, (BATCH, scaler.pooled_length,
                                                1)).astype(np.float32),
                            device=dev)
    windows = torch.as_tensor(rng.normal(0, 1, (BATCH, 300, 1)).astype(
        np.float32), device=dev)
    seq = klstm.bidirectional_lstm(demux.bilstm_fwd, demux.bilstm_bwd,
                                   windows)

    cases = [
        ('lstm2_stacked', 'poreplex_tpu/ops/pallas_rnn.py:102',
         lambda: klstm.lstm2_stacked(scaler.lstm1, scaler.lstm2, heads),
         lambda: rnn.lstm2_stacked(scaler.lstm1, scaler.lstm2, heads),
         torch_lstm([[scaler.lstm1], [scaler.lstm2]]), heads,
         lambda out: out[:, -1],
         lstm_flops(BATCH, heads.shape[1], 1, 48, 1) +
         lstm_flops(BATCH, heads.shape[1], 48, 48, 1),
         heads.numel() * 4 + BATCH * 48 * 4),
        ('bidirectional_lstm', 'poreplex_tpu/ops/pallas_rnn.py:236',
         lambda: klstm.bidirectional_lstm(demux.bilstm_fwd, demux.bilstm_bwd,
                                          windows),
         lambda: rnn.bidirectional_lstm(demux.bilstm_fwd, demux.bilstm_bwd,
                                        windows),
         torch_lstm([[demux.bilstm_fwd, demux.bilstm_bwd]],
                    bidirectional=True), windows, lambda out: out,
         2 * lstm_flops(BATCH, 300, 1, 48, 1),
         windows.numel() * 4 + BATCH * 300 * 96 * 4),
        ('lstm_last', 'poreplex_tpu/ops/pallas_rnn.py:174',
         lambda: klstm.lstm_last(demux.lstm2, seq),
         lambda: rnn.lstm(demux.lstm2, seq, return_sequences=False),
         torch_lstm([[demux.lstm2]]), seq, lambda out: out[:, -1],
         lstm_flops(BATCH, 300, 96, 64, 1),
         seq.numel() * 4 + BATCH * 64 * 4),
    ]
    for name, replaces, kernel, plain, net, xs, pick, flops, nbytes in cases:
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not (np.isfinite(err) and err <= LSTM_ATOL):
            raise AssertionError('{}: kernel vs plain max abs err {} > {}'
                                 .format(name, err, LSTM_ATOL))
        with torch.inference_mode():
            lib_err = float((pick(net(xs)[0]) - got).abs().max())
            library_ms = time_ms(lambda: net(xs), reps=5)
        rows.append(dict(
            name=name, route='cuda', source='poreplex_torch/csrc/lstm.cu',
            replaces=replaces, max_abs_err=err,
            ms=time_ms(kernel, reps=5), plain_ms=time_ms(plain, reps=2),
            library_ms=library_ms, flops=flops, nbytes=nbytes,
            library_err=lib_err))
    return rows


def viterbi_inputs(rng, T):
    """B reads of HMM-like signal with lengths from 1000 to T frames; a
    second adapter-level block exercises last-run extents."""
    from poreplex_torch.simulate import STATE_LEVELS
    x = np.full((BATCH, T), STATE_LEVELS['transcript'][0], np.float32)
    lengths = rng.integers(1000, T + 1, BATCH)
    names = ['pre-leader', 'leader-low', 'leader-high', 'adapter',
             'polya-tail', 'adapter']
    fracs = [0.03, 0.03, 0.02, 0.25, 0.1, 0.05]
    for i, L in enumerate(lengths):
        parts = [rng.normal(*STATE_LEVELS[n], int(L * f))
                 for n, f in zip(names, fracs)]
        used = sum(len(p) for p in parts)
        mu, sd = STATE_LEVELS['transcript']
        parts.append(rng.normal(mu, sd, L - used))
        x[i, :L] = np.concatenate(parts)
    return x, lengths.astype(np.int32)


def check_viterbi(engine, rng):
    from poreplex_torch.kernels import viterbi as kvit
    from poreplex_torch.ops import viterbi as vit_ops
    m = engine.segmodel
    xs, lens = viterbi_inputs(rng, engine.seg_frames)
    x = torch.as_tensor(xs, device=DEVICE)
    lengths = torch.as_tensor(lens, device=DEVICE)
    kernel = lambda: kvit.viterbi_extents(x, lengths, *m.params())
    plain = lambda: vit_ops.viterbi_extents(x, lengths, *m.params())
    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    for name, a, b in zip(('first', 'last', 'present'), got[:3], ref[:3]):
        bad = int((a != b).sum())
        if bad:
            raise AssertionError('viterbi_extents: {} differs in {} entries'
                                 .format(name, bad))
    logp_err = (got[3] - ref[3]).abs()
    rel = float((logp_err / ref[3].abs().clamp(min=1.0)).max())
    if not rel <= LOGP_RTOL:
        raise AssertionError('viterbi_extents: logp rel err {} > {}'.format(
            rel, LOGP_RTOL))
    nstates, ncomp = m.mus.shape
    # per valid frame and read: emission (5 ops per component, then the
    # shift, exps, sum and log per state) and the transition max with its
    # first-occurrence compare and the score update
    per_frame = (nstates * ncomp * 5 + nstates * (4 + 3 * ncomp) +
                 3 * nstates * nstates + nstates)
    frames = int(lens.sum())
    return [dict(
        name='viterbi_extents', route='cuda',
        source='poreplex_torch/csrc/viterbi.cu',
        replaces='poreplex_tpu/ops/pallas_viterbi.py:232',
        max_abs_err=float(logp_err.max()), ms=time_ms(kernel, reps=5),
        plain_ms=time_ms(plain, reps=1), library_ms=None,
        flops=frames * per_frame,
        nbytes=x.numel() * 4 + lengths.numel() * 4 +
        BATCH * nstates * (8 + 8 + 1) + BATCH * 4)]


def kernel_line(row):
    return ('kernel {name}: max_err={max_abs_err:.3g} kernel_ms={ms:.4f} '
            'plain_ms={plain_ms:.2f} library_ms={lib} (library vs kernel '
            'max err {lib_err})'.format(
                lib=('{:.4f}'.format(row['library_ms'])
                     if row['library_ms'] is not None else 'none'),
                lib_err=('{:.3g}'.format(row['library_err'])
                         if 'library_err' in row else 'none'),
                **row))


def run_main_path(config, rng):
    """512 simulated reads through BatchAnalyzer on the card, written with
    the port's writers. Launch counts and stage timers are reset just
    before the analyzer runs and read just after. Returns (results,
    timings, launches, analyzer, every record's stage-1 input)."""
    from poreplex_torch import kernels, simulate
    from poreplex_torch.io.writers import FASTQWriter, SequencingSummaryWriter
    from poreplex_torch.pipeline.analyzer import BatchAnalyzer
    from poreplex_torch.pipeline.read import ReadRecord
    from poreplex_torch.utils import GLOBAL_TIMER

    analyzer = BatchAnalyzer(config)
    # transcripts of about 200 to 2,000 nt (43 raw samples a base)
    reads = [simulate.simulate_read(
        rng, transcript_len=int(rng.integers(*TRANSCRIPT_SAMPLES)),
        barcode=i % 4) for i in range(N_READS)]
    t0 = time.perf_counter()
    results, records = [], []
    for read in reads:
        rec = ReadRecord('simulated.fast5', analyzer.inputdir, read.read_id)
        analyzer.add_read(rec, simulate.MemoryRead(read), results, records)
    ingest_s = time.perf_counter() - t0
    frames = analyzer.engine.seg_frames
    stage1_inputs = [(r.pooled, min(len(r.pooled), frames), r.head_len)
                     for r in records]
    # one stage-1 batch first, so the timed run finds PyTorch's kernels
    # loaded; these launches are not counted
    analyzer.engine.run_stage1_flat(stage1_inputs[:BATCH])

    GLOBAL_TIMER.totals.clear()
    GLOBAL_TIMER.counts.clear()
    kernels.reset_launches()
    t1 = time.perf_counter()
    results = analyzer.process_batch(None, (results, records))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    summary_writer = SequencingSummaryWriter(
        config, config['outputdir'], config['label_names'],
        config['barcode_names'])
    fastq_writer = FASTQWriter(config['outputdir'], config['output_layout'])
    try:
        fastq_writer.write_sequences(results)
        summary_writer.write_results(results)
    finally:
        fastq_writer.close()
        summary_writer.close()
    t2 = time.perf_counter()
    timings = {'ingest_s': ingest_s, 'process_s': t2 - t1,
               'stage1_s': GLOBAL_TIMER.totals['B:device_stage1'],
               'stages': GLOBAL_TIMER.snapshot()}
    return results, timings, launches, analyzer, stage1_inputs


def profile_stage1(engine, reads):
    """One stage-1 batch under torch.profiler: wall time, the device's
    busy share (the union of the device's kernel and copy intervals over
    the wall time) and the device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_stage1_flat(reads)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU operators' rows would count the
    # same kernels twice, and the profiler's own buffer requests none
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and
                   not e.name.startswith('Activity Buffer'))
    busy_us, end = 0.0, float('-inf')
    by_name = {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = busy_us / 1e3
    log('stage-1 profile, {} reads: wall {:.2f} ms, device busy {:.2f} ms '
        '({:.1%}) in {} device events; by name: {}'.format(
            len(reads), wall_ms, busy_ms, busy_ms / wall_ms, len(spans),
            '; '.join('{} {:.3f} ms'.format(name[:60], us / 1e3)
                      for name, us in top)))


def check_outputs(config, results, outdir):
    ids = [r['read_id'] for r in results]
    if len(results) != N_READS or len(set(ids)) != N_READS:
        raise AssertionError('expected {} reports, got {} ({} distinct)'
                             .format(N_READS, len(results), len(set(ids))))
    labels = {}
    for r in results:
        key = (r.get('label'), r['status'])
        labels[key] = labels.get(key, 0) + 1
    log('labels/statuses:', json.dumps({'{}/{}'.format(*k): v
                                        for k, v in sorted(labels.items(),
                                                           key=str)}))
    passed = [r for r in results if r.get('label') == 'pass']
    if len(passed) < 0.9 * N_READS:
        raise AssertionError('only {} of {} reads passed'.format(
            len(passed), N_READS))
    barcoded = [r for r in passed if r.get('barcode') is not None]
    if not barcoded:
        raise AssertionError('no pass read has a barcode')
    log('pass reads with a barcode: {} of {}'.format(len(barcoded),
                                                     len(passed)))
    with open(os.path.join(outdir, 'sequencing_summary.txt')) as f:
        rows = f.read().splitlines()
    if len(rows) != 1 + sum(1 for r in results if 'label' in r):
        raise AssertionError('sequencing summary has {} rows'.format(
            len(rows)))
    nfastq = 0
    for root, _, files in os.walk(os.path.join(outdir, 'fastq')):
        for fn in files:
            with gzip.open(os.path.join(root, fn), 'rt') as f:
                nfastq += sum(1 for _ in f) // 4
    expect = sum(1 for r in results if r.get('sequence') is not None)
    if nfastq != expect:
        raise AssertionError('{} FASTQ records for {} sequences'.format(
            nfastq, expect))


def check_against_cpu(config, analyzer, reads):
    """Stage 1 of the first reads on the card vs the same engine on the
    CPU (plain PyTorch versions of the kernels)."""
    from poreplex_torch.pipeline.engine import DeviceEngine
    cpu_config = dict(config, device='cpu', device_batch_size=len(reads))
    cpu = DeviceEngine(cpu_config)
    gpu, n = analyzer.engine.run_stage1_flat(reads)
    ref, _ = cpu.run_stage1_flat(reads)
    for key in ('first', 'last', 'present', 'qc_ok', 'demux_ok'):
        if not np.array_equal(gpu[key], ref[key]):
            raise AssertionError('stage 1 on cuda vs cpu: {} differs'.format(
                key))
    for key in ('scaling', 'demux_probs'):
        err = float(np.abs(gpu[key] - ref[key]).max())
        if not err <= LSTM_ATOL:
            raise AssertionError('stage 1 on cuda vs cpu: {} err {}'.format(
                key, err))
    log('stage 1 on cuda == cpu for {} reads (extents exact, scaling and '
        'demux probabilities within {})'.format(n, LSTM_ATOL))


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from poreplex_torch.config import build_config
    from poreplex_torch.kernels import _build
    from poreplex_torch.pipeline.engine import DeviceEngine

    t0 = time.perf_counter()
    reports = _build.build_all()
    log('built {} in {:.1f} s'.format(', '.join(reports),
                                       time.perf_counter() - t0))
    for source, report in reports.items():
        for line in report.splitlines():
            if 'registers' in line or 'spill' in line:
                log('  {}: {}'.format(source, line.strip()))
    card = card_line()
    log(card)
    log('torch {} cuda {} on {}'.format(torch.__version__, torch.version.cuda,
                                        torch.cuda.get_device_name(0)))

    with tempfile.TemporaryDirectory() as outdir:
        config = build_config(outdir, outdir, barcoding=True,
                              trim_adapter=True, device='cuda',
                              device_batch_size=BATCH,
                              barcoding_quality_filter=BARCODE_PHRED)
        rng = np.random.default_rng(SEED)

        engine = DeviceEngine(config)
        with torch.inference_mode():
            rows = check_lstms(engine, rng) + check_viterbi(engine, rng)
        del engine
        for row in rows:
            log(kernel_line(row))

        results, timings, launches, analyzer, stage1_inputs = \
            run_main_path(config, rng)
        check_outputs(config, results, outdir)
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError('main path never launched: {}'.format(
                missing))
        log('main path: {} reads, stage 1 {:.1f} reads/s, whole run {:.1f} '
            'reads/s (ingest {:.3f} s, process + write {:.3f} s)'.format(
                N_READS, N_READS / timings['stage1_s'],
                N_READS / (timings['ingest_s'] + timings['process_s']),
                timings['ingest_s'], timings['process_s']))
        log('stage timers:', json.dumps(timings['stages']))
        check_against_cpu(config, analyzer, stage1_inputs[:8])
        profile_stage1(analyzer.engine, stage1_inputs[:BATCH])

    kernels_line = []
    for row in rows:
        bound_ms, bound_by = bound(row['flops'], row['nbytes'])
        kernels_line.append({
            'name': row['name'], 'route': row['route'],
            'source': row['source'], 'replaces': row['replaces'],
            'launches': launches[row['name']],
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': row['library_ms']})
    print(json.dumps({'kernels': kernels_line}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
