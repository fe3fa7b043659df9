#!/usr/bin/env python3
"""Smoke run of poreplex_torch on one CUDA card.

    python3 chip_smoke.py               (from the repository root)
    python3 chip_smoke.py --multi-card  (step 7's phases alone, for a host
                                         of several cards)

1. builds the CUDA kernels from poreplex_torch/csrc/ (one nvcc per source,
   all at once) and prints the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: stage 1 at B = 256 reads (scaler
   T = 2000, demux T = 300, segmentation T = 6666), the poly(A) peak
   detector at [256, 8192], [8, 16384] and, after step 3, [64, 32768] and
   [37, 2002] (against the plain version on CPU copies of the inputs;
   the last one's length is not a multiple of 4), the poly(A)
   DP (both packs of a round in one launch) at [512, 512], [512, 1024],
   [256, 1024] and [128, 1024] and on the adversarial rows of
   simulate.dp_cases (K = 1 to 1500, in either pack), the unsplit Viterbi at [1024, 1024]
   and [1024, 128] and, after step 3, [64, 4096]; the three LSTMs and the
   Viterbi extents also at ragged batches of 37 reads and 1 read; after
   step 3 both Viterbi entries on an HMM whose states 1 and 2 tie on
   every frame (K = 1 and 2, [37, 999]). LSTM outputs within 5e-5
   absolute; Viterbi extents and paths, peak emissions and DP intervals
   exactly equal; Viterbi logp within 1e-5 relative. Times the kernel
   (CUDA events, enqueued behind a device sleep so the host's launch
   overhead is not in the time), the plain version and, where one PyTorch
   call computes the same function, that call (torch.nn.LSTM with the
   converted weights); the LSTM lines also give the time per step, the
   peak detector's and the Viterbis' the time per frame and the DP's the
   time per column, each with the launch (rows per block, threads,
   blocks); then the poly(A) round replayed from captured CUDA graphs
   (ops.polya_round.RoundGraph) against the round op by op, heads and
   spikes bit for bit: blocks of 11 and 16 windows (one row capacity) at
   blen 8,192 and 16,384, every block once, then graphs A, B, A in turn
   before any result is read; the kernel counts equal to the rounds run;
   the host ms of a block op by op and replayed;
3. simulates 512 reads (basecalls included, poly(A) tails of 500 to
   20,000 samples, transcripts of 9,000 to 90,000 raw samples, one in 16
   made of two molecules) from a fixed seed and runs them through
   BatchAnalyzer on the card with barcoding (quality filter phred 7),
   adapter trimming, poly(A) measurement and the unsplit-read filter on,
   writes FASTQ and sequencing_summary.txt, checks the reports, holds the
   first reads' stage-1 outputs against the same engine on the CPU, and
   the poly(A) tails and unsplit decisions of a few reads from each window
   bucket the run used (at least two) against the same analyzer on the
   CPU; every kernel must have been launched on this path; then "kernel
   shapes": the three LSTM wrappers at widths 1, 20, 52, 56, 64, 96, 128
   and 256, input widths 1 and 3, stacked layers of 64 and 32, 32 and 96 units,
   and past what 8 blocks hold whole a stacked LSTM(1100) x 2 and an
   LSTM(2100) ([37, 61], random weights from a generator of its own,
   within 5e-5 of the plain versions; each line names the design
   kernels.lstm.plan chose, whose launch shapes and cluster sizes must
   equal the C side's, with the cluster's cudaOccupancyMaxActiveClusters),
   both Viterbi
   wrappers at 1 to 8 states x 1 to 5 components on random HMMs (every
   instantiation, and the loop over K), at 3 and 8 states x 128
   components, and on the tie HMM at 7 and 8 states ([37, 999], extents,
   paths and logp equal to the plain version's; each launch shape and
   dynamic shared memory equal to the C side's), and kernels 1 to 5 at the
   widened preset's full shapes (simulate.write_widened_preset: the scaler's two LSTM(96)
   at [256, 2000], BiLSTM(56) and LSTM(128) at [256, 300], the 7-state
   3-component extents at [256, 6666], the 8-state 4-component paths at
   [1024, 1024]) against their plain versions, timed as in step 2; the
   widened LSTM(96) x 2 and LSTM(128) must have run in clusters of 2
   blocks or more holding every weight row, the widened BiLSTM(56)
   bilstm_kernel<56> at its own width (no inert unit), and the widened
   Viterbis their unrolled <8,3> and <8,4> instantiations on the general
   design; then the general design's BiLSTM, both directions in one
   launch, at H 128 and [256, 300] from a width-1 input, timed beside
   torch.nn.LSTM;
4. profiles one stage-1 batch and one whole 256-read batch: the device's
   busy share, the ten kernels with the most device time and the port's
   own kernels;
5. runs the same 512 reads, from memory, through the port's command line
   (commandline.main with the main path's options, batches of 256): every
   kernel must launch; prints reads/s from main entered to main returned
   and the stage timers, and the poly(A) graph counters (every launch
   block a capture or a replay); each read's summary row and FASTQ
   record must equal the main path's and .processed-reads must list every
   okay read;
   resumed over the same reads it must analyse only the reads that were
   not okay, and over the okay reads it must launch no kernel and leave a
   header-only summary; then ``python -m poreplex_torch --version`` must
   exit with 0; then the "session, widened preset": the same reads
   through commandline.main with -c the widened preset, where every
   wrapper launches on the widened kernels alone (kernels.instantiations:
   the general LSTM design, bilstm_kernel<56>, the 8-state Viterbis
   unrolled for 3 and 4 components, the peak detector and the DP), prints
   reads/s beside the shipped session's, and holds its first reads
   against the port's CPU session on that preset (summary rows and FASTQ
   records equal; stage 1's extents, QC and demux decisions exact,
   scaling and probabilities within 5e-5); then the host stages through
   the CLI: (a) prints whether
   albacore, mappy and pysam import here and, for each that does not,
   commandline.main with --basecall or --align (a generated .mmi) must
   stop with poreplex-tpu's message and a non-zero exit before any read;
   (b) on chip_smoke's own stand-ins of albacore (each read's simulated
   basecall, found by its signal), mappy (a query maps to the contig that
   holds it), pysam (SAM text) and curses, the same reads from memory
   through commandline.main with --basecall --align --fastq --dashboard
   and the main path's options: every kernel launches, every summary row
   and FASTQ record (U as T) equals the main path's, albacore gets each
   read that reached PHASE C once with range / digitisation * (raw +
   offset) in float32 bit for bit, each read with a sequence reaches the
   aligner once (adapter trimmed), each BAM stream holds exactly its
   reads' rows, the dashboard's tallies equal the counts; prints reads/s,
   D:io_AlignmentWriter.process, C:albacore and the dashboard of the
   finished session; then the same reads from memory through commandline.main
   with -p 1, 2, 4 and 1 in turns, in a process of its own: each run
   launches every kernel and writes the main path's summary rows and
   FASTQ records, -p N starts N ingest worker processes that import
   neither torch nor jax and -p 1 none; prints reads/s, A:fast5_load and
   its A:* parts and os.cpu_count() of each (reads from memory: the
   card's host has no libhdf5, so FAST5 ingest is timed nowhere here);
6. training at full widths: one demux step at [64, 300] and one scaler
   step at [8, 2000] on the card held against the same step on the CPU
   (loss within 1e-5 relative, every gradient within 1e-4 of its tensor's
   largest element); both trainers through train() for a few steps at
   batches of 64 and 32 (ms a step, kernel launches a step from the
   profiler); their checkpoints in DemuxModel and ScalerModel on the card,
   where kernels 1 to 3 must launch and agree within 5e-5 with the
   training forward on the held-out windows and heads; then data-parallel
   training on a world of one NCCL rank (parallel/training.launch, as the
   trainers' --data-parallel runs it): each trainer's fit() at its batch
   of 64 and 32 for 5 steps, the first held against the same step in this
   process from the rank's parameters and global batch, every rank's
   inputs and parameters equal to rank 0's, ms a step (median of 3),
   launches, NCCL device time and busy share of a profiled step, then the
   workflows' evaluate (training/workflow.py, scaler_workflow.py) on the
   ranks' checkpoints, where kernels 1 to 3 must launch; then whether
   libhdf5 can be dlopened (a probe, never a failure) and the native FAST5
   reader built with g++ (a probe too);
7. several cards (on one card, the sharded code on that card): each of the
   seven wrappers on tensors on every visible card with cuda:0 current,
   against its plain version; the main path's reads through a
   BatchAnalyzer on one card, on meshes of 2 and 4 cards where visible,
   and on a mesh of every visible card ([cuda:0, cuda:0] on one card):
   every report equal to one card's, stage 1's decisions exact and its
   scaling and probabilities within 5e-5, every kernel launched on every
   card of the mesh (the profiler's device ids on a mesh of several
   entries), reads/s of each; then
   ranks, processes of this script with one card each (two sharing
   cuda:0 on one card, else one a card up to four), each running
   commandline.main with --num-nodes, --node-rank and --coordinator over
   512 reads it makes from the seed: disjoint manifests, summary rows and
   rank 0's merged counts equal to one process's run of the same reads,
   reads/s from the first rank's start to the last rank's end. Steps 2
   to 6 run on cuda:0 alone (mesh_shape 1) whatever the card count;
8. prints the run's time, a JSON line of the kernels, the card's name and
   power limit, then {"ok": true, ...} last. With --multi-card only step
   1, step 7 (the mesh over the ranks' 512 reads), the data-parallel
   training of step 6 at D = 1, 2 and 4 ranks of one card each (where
   visible; beyond one rank each trainer at its global batch of 64 or 32
   and at that batch a card, the latter profiled) with the workflows'
   evaluate on the checkpoints of the largest D, and the last two lines
   run. Cut to keep
   it short: the first, checked, step is the warm-up, and a step is
   profiled only at the batch a card (launches do not depend on the
   batch).

Any failure raises and exits non-zero before the last line is printed.
"""

import collections
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
# batches of the LSTM kernels beside the main one: not a multiple of a
# block's reads, and one read
RAGGED = (37, 1)
LOGP_RTOL = 1e-5
# published peaks of an H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# gate math per hidden unit and step: three sigmoids, two expm1 tanhs and
# the cell update, counted as elementwise operations
GATE_OPS = 28
# per valid frame of one read: the two detectors' compares, selects and
# subtractions (about 20 each), and per column of one DP row the prefix,
# budget, packed minimum and argmax updates (about 25 int32 operations)
PEAK_FRAME_OPS = 40
DP_COLUMN_OPS = 25
# widths of the adversarial DP rows: one column, odd and even widths
# within one warp's span, ones that do and do not fill the wider chunks
# (528 and 1040 are multiples of 16, not of 32), and one past the span
DP_CASE_WIDTHS = (1, 33, 511, 512, 528, 1024, 1040, 1500)
# the port's kernel functions, whose device time each profile lists
PORT_KERNELS = ('lstm2_stacked_kernel', 'bilstm_kernel', 'lstm_last_kernel',
                'viterbi_extents_kernel', 'viterbi_path_kernel',
                'peaks_kernel', 'dp_kernel')
# reads of each poly(A) window bucket held against the CPU on the main path
CPU_PER_BUCKET = 3
# the training phase, at full widths: the step held against the CPU (a
# scaler step there takes seconds, so its batch is 8), the trainers' batches
# and dataset sizes (windows per class, heads), and their steps (the first
# is a warm-up)
TRAIN_PARITY_BATCH = {'demux': 64, 'scaler': 8}
TRAIN_BATCH = {'demux': 64, 'scaler': 32}
TRAIN_SIZE = {'demux': 100, 'scaler': 400}
TRAIN_STEPS = 4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# one read in 16 is two molecules (a second leader and adapter 40% into
# the transcript, as tests/test_pipeline_e2e.py makes them), the fourth of
# each 16; the CPU check holds the first
TWO_MOLECULES_EVERY = 16
TWO_MOLECULES = dict(extra_adapter_at=0.4, seq_per_event=0.8)
# poly(A) tails drawn uniformly from 500 to 20,000 samples (0.17 to 6.6 s
# at 3,012 Hz), so the windows fall in the 8,192, 16,384 and 32,768-sample
# buckets of pipeline/polya.py
POLYA_SAMPLES = (500, 20001)


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    """Mean device time of fn() over reps launches, by CUDA events: the
    launches are enqueued behind a device sleep of some 5 ms, so the
    host's time to enqueue them is not in the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def two_molecules(i):
    return i % TWO_MOLECULES_EVERY == 3


def timed(fn):
    """(fn(), its device time in ms) of one call: the plain versions'
    loops take seconds at the main path's shapes."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


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


def lstm_plan(name, batch, inputs, hidden1, hidden2=None):
    """kernels.lstm.plan for the shape, each launch's shape and cluster
    held against the ones the C side launches, and each general launch's
    cudaOccupancyMaxActiveClusters read: (the plan, its launch shape (of
    the first launch), a description of the design, the first launch's
    max active clusters (None for the register design))."""
    from poreplex_torch.kernels import lstm as klstm
    pl = klstm.plan(name, batch, inputs, hidden1, hidden2)
    directions = 2 if name == 'bidirectional_lstm' else 1
    fold = inputs == 1 and name != 'lstm_last'
    parts, clusters = [], []
    for launch in pl.launches:
        rows, threads, blocks, cluster = klstm.launch_shape(
            launch.kernel, batch, launch.hidden)
        dirs = launch.shape[2] // blocks
        if ((rows, threads, blocks * dirs) != launch.shape or
                cluster != (launch.cluster or 0)):
            raise AssertionError(
                '{} at {}: plan launches {} in clusters of {}, the C side {} '
                'in clusters of {}'.format(
                    name, [batch, inputs, hidden1, hidden2], launch.shape,
                    launch.cluster, (rows, threads, blocks * dirs), cluster))
        part = '{}<H {}>'.format(launch.kernel, launch.hidden)
        if launch.cluster is not None:
            clusters.append(klstm.max_active_clusters(launch, batch, fold,
                                                      directions))
            part += (' (cluster {}, max active clusters {}; {} rows of each '
                     'matrix in shared memory)'.format(
                         launch.cluster, clusters[-1], launch.smem_rows))
        parts.append(part)
    design = '{} {}'.format(pl.route, ', '.join(parts))
    return pl, pl.launches[0].shape, design, (clusters or [None])[0]


def check_lstms(engine, rng, ragged=RAGGED):
    """The three LSTM kernels on the engine's networks (at their widths)
    at the main path's shapes and at the ragged batches: within LSTM_ATOL
    of their plain versions, timed beside torch.nn.LSTM. Each row keeps
    the kernel functions one call launched and its output's shape."""
    from poreplex_torch import kernels
    from poreplex_torch.kernels import lstm as klstm
    from poreplex_torch.ops import rnn
    scaler, demux = engine.scaler, engine.demux
    dev = DEVICE
    rows = []
    h1, h2 = (scaler.lstm1['recurrent'].shape[0],
              scaler.lstm2['recurrent'].shape[0])
    hb, hl = (demux.bilstm_fwd['recurrent'].shape[0],
              demux.lstm2['recurrent'].shape[0])

    heads = torch.as_tensor(rng.normal(90, 12, (BATCH, scaler.pooled_length,
                                                1)).astype(np.float32),
                            device=dev)
    windows = torch.as_tensor(rng.normal(0, 1, (BATCH, 300, 1)).astype(
        np.float32), device=dev)
    seq = klstm.bidirectional_lstm(demux.bilstm_fwd, demux.bilstm_bwd,
                                   windows)

    # (name, Pallas entry, plan's widths, kernel, plain, torch.nn.LSTM, main
    #  input, the library output's last-h pick, flops(B, T), bytes(B, T))
    cases = [
        ('lstm2_stacked', 'poreplex_tpu/ops/pallas_rnn.py:102', (1, h1, h2),
         lambda xs: klstm.lstm2_stacked(scaler.lstm1, scaler.lstm2, xs),
         lambda xs: rnn.lstm2_stacked(scaler.lstm1, scaler.lstm2, xs),
         torch_lstm([[scaler.lstm1], [scaler.lstm2]]), heads,
         lambda out: out[:, -1],
         lambda B, T: lstm_flops(B, T, 1, h1, 1) + lstm_flops(B, T, h1, h2, 1),
         lambda B, T: B * T * 4 + B * h2 * 4),
        ('bidirectional_lstm', 'poreplex_tpu/ops/pallas_rnn.py:236', (1, hb),
         lambda xs: klstm.bidirectional_lstm(demux.bilstm_fwd,
                                             demux.bilstm_bwd, xs),
         lambda xs: rnn.bidirectional_lstm(demux.bilstm_fwd, demux.bilstm_bwd,
                                           xs),
         torch_lstm([[demux.bilstm_fwd, demux.bilstm_bwd]],
                    bidirectional=True), windows, lambda out: out,
         lambda B, T: 2 * lstm_flops(B, T, 1, hb, 1),
         lambda B, T: B * T * 4 + B * T * 2 * hb * 4),
        ('lstm_last', 'poreplex_tpu/ops/pallas_rnn.py:174', (2 * hb, hl),
         lambda xs: klstm.lstm_last(demux.lstm2, xs),
         lambda xs: rnn.lstm(demux.lstm2, xs, return_sequences=False),
         torch_lstm([[demux.lstm2]]), seq, lambda out: out[:, -1],
         lambda B, T: lstm_flops(B, T, 2 * hb, hl, 1),
         lambda B, T: B * T * 2 * hb * 4 + B * hl * 4),
    ]
    for (name, replaces, widths, kernel, plain, net, xs_main, pick, flops,
         nbytes) in cases:
        for batch in (BATCH,) + tuple(ragged):
            xs = xs_main[:batch].contiguous()
            seqlen = xs.shape[1]
            before = collections.Counter(kernels.instantiations)
            got = kernel(xs)
            functions = dict(kernels.instantiations - before)
            ref, plain_ms = timed(lambda: plain(xs))
            err = float((got - ref).abs().max())
            if not (np.isfinite(err) and err <= LSTM_ATOL):
                raise AssertionError('{} at {} reads: kernel vs plain max '
                                     'abs err {} > {}'.format(
                                         name, batch, err, LSTM_ATOL))
            with torch.inference_mode():
                lib_err = float((pick(net(xs)[0]) - got).abs().max())
                library_ms = time_ms(lambda: net(xs), reps=5)
            pl, launch, design, clusters = lstm_plan(name, batch, *widths)
            rows.append(dict(
                name=name, route='cuda', source='poreplex_torch/csrc/lstm.cu',
                replaces=replaces, shape=[batch, seqlen], max_abs_err=err,
                ms=time_ms(lambda: kernel(xs), reps=5), plain_ms=plain_ms,
                library_ms=library_ms, flops=flops(batch, seqlen),
                nbytes=nbytes(batch, seqlen), library_err=lib_err,
                steps=seqlen, step_unit='step', launch=launch, design=design,
                widths=widths, cluster=pl.launches[0].cluster,
                smem_rows=pl.launches[0].smem_rows, max_clusters=clusters,
                functions=functions, out_shape=list(got.shape),
                kernel_width=pl.launches[0].hidden))
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


def viterbi_frame_ops(nstates, ncomp):
    """Per valid frame and read: emission (5 ops per component, then the
    shift, exps, sum and log per state) and the transition max with its
    first-occurrence compare and the score update."""
    return (nstates * ncomp * 5 + nstates * (4 + 3 * ncomp) +
            3 * nstates * nstates + nstates)


VITERBI_REPLACES = {
    'viterbi_extents': 'poreplex_tpu/ops/pallas_viterbi.py:232',
    'viterbi': 'poreplex_tpu/ops/pallas_viterbi.py:292',
}


def viterbi_row(name, x, lengths, params):
    """The Viterbi entry ``name`` (viterbi_extents or viterbi) on x [B, T]
    against its plain version: extents, present and paths equal, logp
    within LOGP_RTOL relative."""
    from poreplex_torch.kernels import viterbi as kvit
    from poreplex_torch.ops import viterbi as vit_ops
    batch, seqlen = x.shape
    nstates, ncomp = params[2].shape
    pl = kvit.plan(nstates, ncomp, batch)
    launch, smem, design = kvit.launch_shape(batch, nstates, ncomp)
    if (pl.launch, pl.smem, pl.design) != (launch, smem, design):
        raise AssertionError('{}: plan launches {} with {} bytes of dynamic '
                             'shared memory on the {} design, the C side {} '
                             'with {} on the {}'.format(
                                 name, pl.launch, pl.smem, pl.design, launch,
                                 smem, design))
    function = kvit.function('viterbi_extents_kernel' if name ==
                             'viterbi_extents' else 'viterbi_path_kernel', pl)
    kernel = lambda: getattr(kvit, name)(x, lengths, *params)
    got = kernel()
    ref, plain_ms = timed(lambda: getattr(vit_ops, name)(x, lengths, *params))
    for a, b in zip(got[:-1], ref[:-1]):
        bad = int((a != b).sum())
        if bad:
            raise AssertionError('{} at {}: {} entries differ from the plain '
                                 'version'.format(name, [batch, seqlen], bad))
    logp_err = (got[-1] - ref[-1]).abs()
    rel = float((logp_err / ref[-1].abs().clamp(min=1.0)).max())
    if not rel <= LOGP_RTOL:
        raise AssertionError('{} at {}: logp rel err {} > {}'.format(
            name, [batch, seqlen], rel, LOGP_RTOL))
    # x and the lengths, then the extents (first, last, present) or the
    # int64 path, and logp
    out = (batch * nstates * (8 + 8 + 1) if name == 'viterbi_extents'
           else batch * seqlen * 8)
    return dict(
        name=name, route='cuda', source='poreplex_torch/csrc/viterbi.cu',
        replaces=VITERBI_REPLACES[name], shape=[batch, seqlen],
        max_abs_err=float(logp_err.max()), ms=time_ms(kernel, reps=5),
        plain_ms=plain_ms, library_ms=None,
        flops=int(lengths.clamp(max=seqlen).sum()) *
        viterbi_frame_ops(nstates, ncomp),
        nbytes=x.numel() * 4 + batch * 4 + out + batch * 4,
        steps=seqlen, step_unit='frame', launch=launch, function=function,
        viterbi_design=design,
        design='{} for {} states, {} components, the {} design{}'.format(
            function, nstates, ncomp, design,
            ', {} bytes of dynamic shared memory'.format(smem) if smem
            else ''))


def check_viterbi(engine, rng, ragged=RAGGED):
    """The segmentation Viterbi extents at the main path's shape and at the
    ragged batches."""
    xs, lens = viterbi_inputs(rng, engine.seg_frames)
    x = torch.as_tensor(xs, device=DEVICE)
    lengths = torch.as_tensor(lens, device=DEVICE)
    return [viterbi_row('viterbi_extents', x[:batch], lengths[:batch],
                        engine.segmodel.params())
            for batch in (BATCH,) + tuple(ragged)]


def check_viterbi_ties(rng, batch=37, seqlen=999):
    """Both Viterbi entries on the tie HMM (simulate.tie_hmm), K = 1 and 2,
    against their plain versions, on signal at its states' levels (lengths
    from 1 to seqlen; seqlen is not a multiple of the kernels' tile, and
    odd, so the path is written with 8-byte stores)."""
    from poreplex_torch.kernels import viterbi as kvit
    from poreplex_torch.simulate import tie_hmm
    rows = []
    for ncomp in (1, 2):
        params = [torch.as_tensor(a, device=DEVICE) for a in tie_hmm(ncomp)]
        levels = rng.choice(params[2][:, 0].cpu().numpy(),
                            (batch, seqlen // 20 + 1))
        xs = (np.repeat(levels, 20, axis=1)[:, :seqlen] +
              rng.normal(0, 3.0, (batch, seqlen))).astype(np.float32)
        lens = rng.integers(1, seqlen + 1, batch).astype(np.int32)
        lens[:2] = (1, seqlen)
        x = torch.as_tensor(xs, device=DEVICE)
        lengths = torch.as_tensor(lens, device=DEVICE)
        for name in ('viterbi_extents', 'viterbi'):
            rows.append(viterbi_row(name, x, lengths, params))
        path = kvit.viterbi(x, lengths, *params)[0]
        if bool((path == 2).any()) or not bool((path == 1).any()):
            raise AssertionError('tie HMM, K = {}: a tie did not go to the '
                                 'lower state'.format(ncomp))
    return rows


def polya_windows(rng, rows, T):
    """Poly(A) windows as the main path cuts them, in scaled pA: the
    adapter's end, a tail over about 40% of the window, then transcript,
    with lengths from T/4 to T."""
    from poreplex_torch.simulate import STATE_LEVELS
    x = np.zeros((rows, T), np.float32)
    lengths = rng.integers(T // 4, T + 1, rows)
    for i, L in enumerate(lengths):
        tail = int(L * 0.4)
        rest = L - 200 - tail
        mu, sd = STATE_LEVELS['transcript']
        x[i, :L] = np.concatenate([
            rng.normal(*STATE_LEVELS['adapter'], 200),
            rng.normal(*STATE_LEVELS['polya-tail'], tail),
            np.repeat(rng.normal(mu, sd, rest // 35 + 1), 35)[:rest] +
            rng.normal(0, 2.0, rest)])
    return x, lengths.astype(np.int32)


def exact_row(name, source, replaces, shape, got, ref, kernel, plain_ms,
              flops, nbytes):
    """A kernel row whose outputs must equal the plain version's."""
    for a, b in zip(got, ref):
        bad = int((a != b).sum())
        if bad:
            raise AssertionError('{} at {}: {} entries differ from the '
                                 'plain version'.format(name, shape, bad))
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                shape=shape, max_abs_err=0.0, ms=time_ms(kernel, reps=5),
                plain_ms=plain_ms, library_ms=None, flops=flops,
                nbytes=nbytes)


def check_peaks(rng, polya_config, shapes, plain_device=DEVICE):
    """The dual peak detector on t-statistics of poly(A) windows of each
    [B, T] of shapes, against its plain version on plain_device: on the
    CPU, CPU copies of the inputs (the plain version's loop of small
    launches would take some 30 s on the card at [64, 32768]), and its
    plain_ms is then the CPU's."""
    from poreplex_torch.kernels import event_detection as ked
    from poreplex_torch.ops import event_detection as ed
    p = polya_config['event_detection']
    args = (float(p['threshold1']), float(p['threshold2']),
            p['window_length1'], p['window_length2'], float(p['peak_height']))
    rows = []
    for B, T in shapes:
        xs, lens = polya_windows(rng, B, T)
        x = torch.as_tensor(xs, device=DEVICE)
        lengths = torch.as_tensor(lens, device=DEVICE)
        _, cs, css = ed._centered_cumsums(x, lengths)
        t1 = ed.compute_tstat(cs, css, lengths, p['window_length1'])
        t2 = ed.compute_tstat(cs, css, lengths, p['window_length2'])
        kernel = lambda: ked.detect_peaks(t1, t2, lengths, *args)
        got = kernel()
        if plain_device == DEVICE:
            ref, plain_ms = timed(lambda: ed.detect_peaks(t1, t2, lengths,
                                                          *args))
        else:
            t0 = time.perf_counter()
            ref = ed.detect_peaks(t1.cpu(), t2.cpu(), lengths.cpu(), *args)
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = [g.cpu() for g in got]
        row = exact_row(
            'detect_peaks', 'poreplex_torch/csrc/event_detection.cu',
            'poreplex_tpu/ops/pallas_event_detection.py:137', [B, T], got,
            ref, kernel, plain_ms,
            flops=int(lens.sum()) * PEAK_FRAME_OPS,
            # the two t-statistics over the valid frames, both emission
            # streams over every frame, the lengths
            nbytes=2 * 4 * int(lens.sum()) + 2 * 4 * B * T + 4 * B)
        row.update(steps=T, step_unit='frame', launch=ked.launch_shape(B),
                   plain_on=plain_device)
        rows.append(row)
    return rows


def check_dp(rng):
    """The interval DP as a round launches it, packs A and B of R windows
    in one launch over their one length and count ([2R, K] rows), at the
    main path's launches: 256 windows of 8,192 samples (K = 512), 128 of
    16,384 and 64 of 32,768 (K = 1024), and 256 windows at K = 1024, the
    widest launch of that table. Then the adversarial rows of
    simulate.dp_cases at each K of DP_CASE_WIDTHS, in pack A and then in
    pack B of the same two-pack launch, beside a random mask.
    The first two shapes draw from rng as before; the rest from a
    generator of their own, so the main path's reads do not change."""
    from poreplex_torch.kernels import polya_dp as kdp
    from poreplex_torch.ops import polya_dp as dp_ops
    from poreplex_torch.simulate import dp_cases
    own = np.random.default_rng(SEED + 3)
    rows = []
    for N, K in ((2 * BATCH, 512), (2 * BATCH, 1024), (BATCH, 1024),
                 (BATCH // 2, 1024)):
        gen = rng if N == 2 * BATCH else own
        isp = torch.as_tensor(gen.uniform(size=(N, K)) < 0.6, device=DEVICE)
        ln = torch.as_tensor(gen.integers(1, 300, (N, K)).astype(np.float32),
                             device=DEVICE)
        counts = gen.integers(K // 8, K + 1, N).astype(np.int32)
        R = N // 2
        a, b, ln, counts = isp[:R], isp[R:], ln[:R], counts[:R]
        n = torch.as_tensor(counts, device=DEVICE)
        kernel = lambda: kdp.dp(a, b, ln, n, 1.5, 110)
        got = kernel()
        ref, plain_ms = timed(lambda: dp_ops.dp_core(
            torch.cat([a, b]), torch.cat([ln, ln]), torch.cat([n, n]), 1.5,
            110))
        row = exact_row(
            'polya_dp', 'poreplex_torch/csrc/polya_dp.cu',
            'poreplex_tpu/ops/pallas_polya_dp.py:114', [N, K], got, ref,
            kernel, plain_ms, flops=2 * int(counts.sum()) * DP_COLUMN_OPS,
            # both masks and the one length over each row's events, the
            # counts, the three outputs of both packs
            nbytes=6 * int(counts.sum()) + 4 * R + 3 * 4 * N)
        row.update(steps=K, step_unit='column', launch=kdp.launch_shape(N))
        rows.append(row)
    held = []
    for K in DP_CASE_WIDTHS:
        ip, ln, n = (torch.as_tensor(x, device=DEVICE)
                     for x in dp_cases(own, 48, K))
        other = torch.as_tensor(own.uniform(size=tuple(ip.shape)) < 0.6,
                                device=DEVICE)
        ref = dp_ops.dp_core(torch.cat([ip, other]), torch.cat([ln, ln]),
                             torch.cat([n, n]), 1.5, 110)
        # the adversarial rows in pack A, then in pack B
        for first, pair in ((True, (ip, other)), (False, (other, ip))):
            got = kdp.dp(*pair, ln, n, 1.5, 110)
            for a, b in zip(got, ref):
                want = b if first else torch.cat([b[48:], b[:48]])
                bad = int((a != want).sum())
                if bad:
                    raise AssertionError(
                        'polya_dp on simulate.dp_cases at K = {}, pack {}: '
                        '{} entries differ from the plain version'.format(
                            K, 'A' if first else 'B', bad))
        held.append('{} ({} found)'.format(K, int((ref[2][:48] > 0).sum())))
    log('polya_dp on simulate.dp_cases in pack A and in pack B == plain '
        'version, 48 rows at K = ' + ', '.join(held))
    return rows


# the graph check's launch blocks: two row counts of one row capacity, in
# two buckets, from a generator of its own
GRAPH_ROWS = (11, 16)
GRAPH_BUCKETS = (8192, 16384)
GRAPH_SEED = SEED + 6
# the poly(A) graph counters of a session
GRAPH_COUNTERS = ('C:polya/graph_capture', 'C:polya/graph_replay',
                  'C:polya/graph_pad_rows')


def polya_block(rng, rows, blen, polya_config):
    """A launch block of ``rows`` poly(A) windows of bucket ``blen`` as
    PolyaAnalyzer._launch builds it: (u16 wire, meta [rows, META_COLS])."""
    from poreplex_torch.ops.polya_round import META_COLS
    from poreplex_torch.pipeline.polya import quantize
    xs, lens = polya_windows(rng, rows, blen)
    loc, scale = polya_config['polya_mean_dist']
    half = scale * polya_config['polya_mean_z_cutoff']
    meta = np.zeros((rows, META_COLS), np.float32)
    wires, offset = [], 0
    for i in range(rows):
        q, (lo, step) = quantize(xs[i, :lens[i]], (1.0, 0.0))
        meta[i] = (offset, len(q), 200, loc - half, loc + half, lo, step)
        wires.append(q)
        offset += len(q)
    return np.concatenate(wires), meta


def check_polya_graphs(polya_config):
    """The poly(A) round replayed from captured CUDA graphs
    (ops.polya_round.RoundGraph) against the round op by op on the same
    blocks, heads and spikes bit for bit: blocks of 11 and 16 windows (one
    row capacity, so one graph) at blen 8,192 and 16,384; first every
    block once (a graph's first call captures), then graphs A, B, A in
    turn before any result is read. The kernel counts must equal the
    rounds run. Prints the host ms of a block op by op and replayed."""
    from poreplex_torch import kernels
    from poreplex_torch.ops import polya_round as round_ops
    from poreplex_torch.pipeline import polya as polya_mod
    rng = np.random.default_rng(GRAPH_SEED)
    analyzer = polya_mod.PolyaAnalyzer(polya_config, device=DEVICE)
    device = analyzer.device
    before = dict(kernels.launches)
    blocks = []
    for blen in GRAPH_BUCKETS:
        params = dict(analyzer._round, max_spikes=polya_mod._MAX_SPIKES,
                      max_peaks=polya_mod._BUCKET_PEAKS[blen])
        for rows in GRAPH_ROWS:
            wire, meta = polya_block(rng, rows, blen, polya_config)
            eager = round_ops.polya_round(
                analyzer._upload([wire], device),
                torch.from_numpy(meta).to(device), blen=blen, **params)
            graph = round_ops.round_graph(
                device, blen, polya_mod.row_capacity(rows, blen), **params)
            blocks.append(dict(blen=blen, rows=rows, graph=graph, wire=wire,
                               meta=meta, ref=[t.cpu() for t in eager]))
    if len({id(b['graph']) for b in blocks}) != len(GRAPH_BUCKETS):
        raise AssertionError('blocks of {} rows took more than one graph a '
                             'bucket'.format(GRAPH_ROWS))
    a_11, a_16, b_11, b_16 = blocks
    turns = [('every block once', blocks),
             ('A, B, A in turn', [a_16, b_11, a_11])]
    captured = 0
    for label, order in turns:
        got = [b['graph'](b['wire'], b['meta']) for b in order]
        for b, (heads, spikes, capture) in zip(order, got):
            captured += capture
            for name, g, r in (('heads', heads, b['ref'][0]),
                               ('spikes', spikes, b['ref'][1])):
                g = g.cpu()
                if g.shape != r.shape or not np.array_equal(
                        g.numpy().view(np.int32), r.numpy().view(np.int32)):
                    raise AssertionError(
                        'poly(A) graph ({}): {} of {} rows at blen {} differ '
                        'from the round op by op'.format(label, name,
                                                         b['rows'], b['blen']))
    rounds = len(blocks) + sum(len(order) for _, order in turns)
    for name in ('detect_peaks', 'polya_dp'):
        if kernels.launches[name] - before[name] != rounds:
            raise AssertionError('{} counted {} launches for {} rounds'.format(
                name, kernels.launches[name] - before[name], rounds))

    def host_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return enqueue, (time.perf_counter() - t0) * 1e3 / reps

    b = a_16
    params = dict(analyzer._round, max_spikes=polya_mod._MAX_SPIKES,
                  max_peaks=polya_mod._BUCKET_PEAKS[b['blen']])
    eager_ms = host_ms(lambda: round_ops.polya_round(
        analyzer._upload([b['wire']], device),
        torch.from_numpy(b['meta']).to(device), blen=b['blen'], **params))
    graph_ms = host_ms(lambda: b['graph'](b['wire'], b['meta']))
    log('poly(A) graphs: {} blocks of {} rows at blen {} ({} captured here) '
        'equal to the round op by op, heads and spikes bit for bit, also '
        'with A, B, A replayed in turn; launches counted {} a kernel; a '
        'block of 16 at 8,192: op by op {:.2f} ms enqueued, {:.2f} ms '
        'done; replayed {:.2f} and {:.2f}'.format(
            rounds - len(blocks), GRAPH_ROWS, GRAPH_BUCKETS, captured,
            rounds, *eager_ms, *graph_ms))


def check_unsplit_viterbi(unsplitmodel, rng, shapes):
    """The full-path Viterbi of the unsplit HMM on event-mean windows of
    each [R, T] of shapes."""
    from poreplex_torch.simulate import STATE_LEVELS
    means = [mu for mu, _ in STATE_LEVELS.values()]
    rows = []
    for R, T in shapes:
        lens = rng.integers(T // 2, T + 1, R).astype(np.int32)
        levels = rng.choice(means, (R, T // 8 + 1))
        xs = (np.repeat(levels, 8, axis=1)[:, :T] +
              rng.normal(0, 3.0, (R, T))).astype(np.float32)
        rows.append(viterbi_row('viterbi', torch.as_tensor(xs, device=DEVICE),
                                torch.as_tensor(lens, device=DEVICE),
                                unsplitmodel.params()))
    return rows


# the "kernel shapes" grid: every LSTM wrapper at each width and input
# width, the stacked one also at layers of unequal widths, at [37, 61]
# (within LSTM_ATOL); both Viterbis at 1 to 8 states x 1 to 5 components
# (every instantiation: K 1 to 4 unrolled, 5 the loop over K), the loop
# over K at SHAPE_MANY_COMPONENTS (its dynamic shared memory past 48 KB:
# every component kept at 200, part of them at 600, the parameters in
# device memory at 1,100), the tie HMM at 7 and 8 states, and HMMs and
# signal outside the range of the unrolled mixtures' fast division
# (division_edge_hmms), at [37, 999] (exact, logp included)
SHAPE_HIDDEN = (1, 20, 52, 56, 64, 96, 128, 256)
SHAPE_INPUTS = (1, 3)
SHAPE_STACKED_PAIRS = ((64, 32), (32, 96))
# past what 8 blocks hold whole: rows read from device memory, and warps
# that take two passes over their units (wrapper, input width, widths)
SHAPE_WIDEST = (('lstm2_stacked', 1, 1100, 1100), ('lstm_last', 3, 2100, None))
SHAPE_STATES = tuple(range(1, 9))
SHAPE_COMPONENTS = (1, 2, 3, 4, 5)
SHAPE_MANY_COMPONENTS = ((3, 200), (8, 200), (3, 600), (8, 1100))
SHAPE_DIVISION_STATES = (3, 8)
SHAPE_DIVISION_COMPONENTS = (3, 4, 5)
SHAPE_BATCH = 37
SHAPE_LSTM_T = 61
SHAPE_VITERBI_T = 999


def random_layer(rng, inputs, hidden):
    """Random LSTM weights on the card, spread as the shipped LSTM(48)'s
    (0.3), shrunk as 1 / sqrt(fan-in) past 48 inputs, as a trained wide
    layer's are (tests/test_torch_kernel_shapes.py)."""
    def spread(fan_in):
        return 0.3 * min(1.0, (48.0 / fan_in) ** 0.5)
    return {key: torch.as_tensor(rng.normal(0, scale, shape).astype(
        np.float32), device=DEVICE) for key, scale, shape in (
            ('kernel', spread(inputs), (inputs, 4 * hidden)),
            ('recurrent', spread(hidden), (hidden, 4 * hidden)),
            ('bias', 0.1, (4 * hidden,)))}


@torch.inference_mode()
def check_lstm_shapes(rng):
    """The three LSTM wrappers over the grid, each against its plain
    version on the card; prints each wrapper's shapes by design with the
    largest error, and returns {design: count}."""
    from poreplex_torch.kernels import lstm as klstm
    from poreplex_torch.ops import rnn
    cases = []
    for inputs in SHAPE_INPUTS:
        for hidden in SHAPE_HIDDEN:
            cases += [('lstm2_stacked', inputs, hidden, hidden),
                      ('bidirectional_lstm', inputs, hidden, None),
                      ('lstm_last', inputs, hidden, None)]
        cases += [('lstm2_stacked', inputs, h1, h2)
                  for h1, h2 in SHAPE_STACKED_PAIRS]
    cases += list(SHAPE_WIDEST)
    seen = {}
    for name, inputs, h1, h2 in cases:
        xs = torch.as_tensor(rng.normal(0, 1, (
            SHAPE_BATCH, SHAPE_LSTM_T, inputs)).astype(np.float32),
            device=DEVICE)
        first = random_layer(rng, inputs, h1)
        if name == 'lstm2_stacked':
            second = random_layer(rng, h1, h2)
            got = klstm.lstm2_stacked(first, second, xs)
            ref = rnn.lstm2_stacked(first, second, xs)
        elif name == 'bidirectional_lstm':
            second = random_layer(rng, inputs, h1)
            got = klstm.bidirectional_lstm(first, second, xs)
            ref = rnn.bidirectional_lstm(first, second, xs)
        else:
            got = klstm.lstm_last(first, xs)
            ref = rnn.lstm(first, xs, return_sequences=False)
        err = float((got - ref).abs().max())
        shape = [SHAPE_BATCH, SHAPE_LSTM_T, inputs, h1] + ([h2] if h2 else [])
        if got.shape != ref.shape or not err <= LSTM_ATOL:
            raise AssertionError('kernel shapes: {} at [B, T, I, H...] = {}: '
                                 'shape {}, max abs err {} > {}'.format(
                                     name, shape, tuple(got.shape), err,
                                     LSTM_ATOL))
        pl, _, design, _ = lstm_plan(name, SHAPE_BATCH, inputs, h1, h2)
        key = (name, pl.route)
        count, worst = seen.get(key, (0, 0.0))
        seen[key] = (count + 1, max(worst, err))
        log('kernel shapes: {} at [B, T, I, H...] = {}: max abs err {:.3g} '
            'vs plain; {}'.format(name, shape, err, design))
    for (name, route), (count, worst) in sorted(seen.items()):
        log('kernel shapes: {} {} design at {} shapes within {} of plain '
            '(max abs err {:.3g})'.format(name, route, count, LSTM_ATOL,
                                          worst))
    check_full_spread(rng)
    return seen


@torch.inference_mode()
def check_full_spread(rng, seeds=3, factor=10.0):
    """The stacked general kernel at the grid's LSTM(128) shape with the
    unshrunk spread 0.3, where float32 rounding grows past LSTM_ATOL
    (tests/test_torch_kernel_shapes.py): the kernel and the plain version
    against the plain version in float64 on the same weights. The kernel
    may leave float64 by no more than ``factor`` times the plain version's
    float32 does (or LSTM_ATOL): a faulty index or a lost term reads some
    1e-2 and more."""
    from poreplex_torch.kernels import lstm as klstm
    from poreplex_torch.ops import rnn
    for _ in range(seeds):
        layers = [{key: torch.as_tensor(rng.normal(0, scale, shape).astype(
            np.float32), device=DEVICE) for key, scale, shape in (
                ('kernel', 0.3, (inputs, 512)),
                ('recurrent', 0.3, (128, 512)), ('bias', 0.1, (512,)))}
            for inputs in (1, 128)]
        xs = torch.as_tensor(rng.normal(0, 1, (
            SHAPE_BATCH, SHAPE_LSTM_T, 1)).astype(np.float32), device=DEVICE)
        got = klstm.lstm2_stacked(*layers, xs)
        plain = rnn.lstm2_stacked(*layers, xs)
        exact = rnn.lstm2_stacked(
            *[{k: v.double() for k, v in p.items()} for p in layers],
            xs.double())
        errs = [float((a.double() - exact).abs().max()) for a in (got, plain)]
        err = float((got - plain).abs().max())
        if not errs[0] <= factor * max(errs[1], LSTM_ATOL):
            raise AssertionError(
                'kernel shapes: stacked LSTM(128) at spread 0.3: kernel - '
                'float64 {:.3g} against plain - float64 {:.3g}'.format(*errs))
        log('kernel shapes: stacked LSTM(128) [{}, {}] at spread 0.3: kernel '
            '- plain {:.3g}, kernel - float64 {:.3g}, plain - float64 {:.3g} '
            '(float32 rounding, not the kernel)'.format(
                SHAPE_BATCH, SHAPE_LSTM_T, err, *errs))


def division_edge_hmms(rng):
    """(kind, HMM arrays, (signal, lengths)) at SHAPE_DIVISION_STATES x
    SHAPE_DIVISION_COMPONENTS outside the range where the unrolled
    mixtures' fast division rounds as the IEEE division
    (csrc/viterbi.cu fast_div_operand, fast_div_divisor), so that they
    take the IEEE division: every sigma below 1 (an HMM of a normalised
    signal), every sigma above 2^20, and pA signal with frames at 0 (in
    the range) and +-1e-30 (outside it)."""
    from poreplex_torch import simulate
    cases = []
    for s in SHAPE_DIVISION_STATES:
        for k in SHAPE_DIVISION_COMPONENTS:
            start, trans, mus, sigmas, logw = simulate.random_hmm(rng, s, k)
            norm = [start, trans, ((mus - 92.5) / 20).astype(np.float32),
                    (sigmas / 20).astype(np.float32), logw]
            cases.append(('sigma below 1', norm, simulate.hmm_signal(
                rng, norm[2], SHAPE_BATCH, SHAPE_VITERBI_T, noise=0.15)))
            wide = [start, trans, mus, (sigmas * 2.0 ** 19.2).astype(
                np.float32), logw]
            cases.append(('sigma above 2^20', wide, simulate.hmm_signal(
                rng, mus, SHAPE_BATCH, SHAPE_VITERBI_T)))
            x, lens = simulate.hmm_signal(rng, mus, SHAPE_BATCH,
                                          SHAPE_VITERBI_T)
            for i, v in enumerate((0.0, 1e-30, -1e-30)):
                x[:, i::97] = v
            cases.append(('x at 0 and +-1e-30',
                          [start, trans, mus, sigmas, logw], (x, lens)))
    return cases


# fast_div beside the IEEE division (tools/viterbi_fast_div.cu, built with
# csrc/viterbi.cu's flags): the edges of its range, just past them, and
# random operands in it
FAST_DIV_SOURCE = os.path.join('tools', 'viterbi_fast_div.cu')
FAST_DIV_RANDOM = 1 << 22
FAST_DIV_SEED = SEED + 31


def start_fast_div_build():
    """Starts nvcc on FAST_DIV_SOURCE into build/ (beside the package's
    own build); returns (process, library path) for fast_div_library."""
    from poreplex_torch.kernels import _build
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, 'build', 'fast_div')
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, 'viterbi_fast_div.so')
    return subprocess.Popen(
        [_build.nvcc_path()] + _build.flags('viterbi.cu') +
        ['-o', lib, os.path.join(root, FAST_DIV_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def fast_div_operands(rng):
    """(x, mu, b) float32 triples [n, 3] and whether each is inside
    fast_div's range (as fast_div_operand and fast_div_divisor state it):
    every pair of x and mu at an edge (0, +-2^-56 and
    the float above it, +-2^99 and the float below it) over b at an edge
    (1 and the float above it, 2^20 and the float below it); operands just
    past an edge (outside); mu one float above x; signal levels in pA;
    random magnitudes from 2^-56 to 2^99 of either sign over b from 1 to
    2^20."""
    f = np.float32
    edge = [f(0.0)]
    for v in (f(2.0 ** -56), np.nextafter(f(2.0 ** -56), f(1)),
              f(2.0 ** 99), np.nextafter(f(2.0 ** 99), f(0))):
        edge += [v, -v]
    bedge = [f(1.0), np.nextafter(f(1.0), f(2)), f(2.0 ** 20),
             np.nextafter(f(2.0 ** 20), f(0))]
    grid = np.array([(x, m, b) for x in edge for m in edge for b in bedge],
                    np.float32)
    past_op = [np.nextafter(f(2.0 ** -56), f(0)), f(1e-30),
               np.nextafter(f(2.0 ** 99), f(np.inf)), f(2.0 ** 100)]
    past_b = [np.nextafter(f(1.0), f(0)), f(0.5),
              np.nextafter(f(2.0 ** 20), f(np.inf)), f(2.0 ** 21)]
    past = np.array([(x, f(3.0), f(5.0)) for x in past_op] +
                    [(f(3.0), m, f(5.0)) for m in past_op] +
                    [(f(3.0), f(7.0), b) for b in past_b], np.float32)
    n = FAST_DIV_RANDOM

    def magnitudes():
        return (rng.choice((-1.0, 1.0), n) *
                np.exp2(rng.uniform(-56.0, 99.0, n))).astype(np.float32)
    x = magnitudes()
    near = np.stack([x, np.nextafter(x, f(np.inf)),
                     np.exp2(rng.uniform(0.0, 20.0, n)).astype(np.float32)],
                    1)
    pa = np.stack([rng.uniform(0.0, 200.0, n), rng.uniform(40.0, 140.0, n),
                   rng.uniform(1.0, 13.0, n)], 1).astype(np.float32)
    wide = np.stack([magnitudes(), magnitudes(), np.exp2(rng.uniform(
        0.0, 20.0, n)).astype(np.float32)], 1)
    triples = np.concatenate([grid, past, near, pa, wide])

    def operand(v):
        v = np.abs(v)
        return (v == 0) | ((v >= 2.0 ** -56) & (v <= 2.0 ** 99))
    inside = (operand(triples[:, 0]) & operand(triples[:, 1]) &
              (triples[:, 2] >= 1) & (triples[:, 2] <= 2.0 ** 20))
    assert inside[:len(grid)].all() and \
        not inside[len(grid):len(grid) + len(past)].any()
    return triples, inside


def fast_div_library(build):
    """Waits for start_fast_div_build's nvcc; returns the library."""
    import ctypes
    proc, path = build
    report = proc.communicate()[0]
    if proc.returncode != 0:
        raise AssertionError('nvcc failed on {}:\n{}'.format(FAST_DIV_SOURCE,
                                                             report))
    lib = ctypes.CDLL(path)
    lib.pp_fast_div.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 4
    return lib


def check_fast_div(lib, rng):
    """Fails unless fast_div(x - mu, b) equals (x - mu) / b in every bit
    on every triple inside its range (fast_div_operands), and its guards
    put each triple where fast_div_operands does."""
    triples, want_inside = fast_div_operands(rng)
    t = torch.as_tensor(triples.T.copy(), device=DEVICE)
    n = t.shape[1]
    inside = torch.empty(n, dtype=torch.int32, device=DEVICE)
    fast, ieee = (torch.empty(n, device=DEVICE) for _ in range(2))
    from poreplex_torch.kernels import _build
    _build.check(lib.pp_fast_div(
        _build.ptr(t[0]), _build.ptr(t[1]), _build.ptr(t[2]), n,
        _build.ptr(inside), _build.ptr(fast), _build.ptr(ieee),
        _build.stream(t.device)), 'fast_div')
    inside = inside.bool().cpu().numpy()
    misplaced = int((inside != want_inside).sum())
    differ = int((fast.view(torch.int32) != ieee.view(torch.int32))
                 .cpu().numpy()[inside].sum())
    log('fast_div: {} of {} triples inside its range (every edge pair, '
        'random operands), {} quotients differ from the IEEE division\'s, '
        '{} triples placed otherwise by its guards'.format(
            int(inside.sum()), n, differ, misplaced))
    if differ or misplaced:
        raise AssertionError('fast_div: {} quotients differ, {} triples '
                             'misplaced'.format(differ, misplaced))


@torch.inference_mode()
def check_viterbi_shapes(rng):
    """Both Viterbi wrappers at every states x components of the grid on a
    random HMM, on the tie HMM at 7 and 8 states and on division_edge_hmms,
    against one plain decode each: extents, paths and logp equal, and
    plan's launch, dynamic shared memory and design equal to the C
    side's."""
    from poreplex_torch import simulate
    from poreplex_torch.kernels import viterbi as kvit
    from poreplex_torch.ops import viterbi as vit_ops
    hmms = [('random', simulate.random_hmm(rng, s, k), None)
            for s in SHAPE_STATES for k in SHAPE_COMPONENTS]
    hmms += [('random', simulate.random_hmm(rng, s, k), None)
             for s, k in SHAPE_MANY_COMPONENTS]
    hmms += [('tie', simulate.tie_hmm(k, s), None) for s in (7, 8)
             for k in SHAPE_COMPONENTS]
    hmms += division_edge_hmms(rng)
    designs = {}
    for kind, arrays, signal in hmms:
        params = [torch.as_tensor(a, device=DEVICE) for a in arrays]
        nstates, ncomp = arrays[2].shape
        xs, lens = signal or simulate.hmm_signal(rng, arrays[2], SHAPE_BATCH,
                                                 SHAPE_VITERBI_T)
        x = torch.as_tensor(xs, device=DEVICE)
        lengths = torch.as_tensor(lens, device=DEVICE)
        path, logp = vit_ops.viterbi(x, lengths, *params)
        ref = vit_ops.segment_extents(path, lengths, nstates) + (logp,)
        got = kvit.viterbi_extents(x, lengths, *params)
        got_path, got_logp = kvit.viterbi(x, lengths, *params)
        for what, a, b in (('first', got[0], ref[0]), ('last', got[1], ref[1]),
                           ('present', got[2], ref[2]),
                           ('extents logp', got[3], ref[3]),
                           ('path', got_path, path), ('path logp', got_logp,
                                                      logp)):
            if a.shape != b.shape or not bool((a == b).all()):
                raise AssertionError(
                    'kernel shapes: {} HMM, {} states x {} components: {} '
                    'differs from the plain version'.format(
                        kind, nstates, ncomp, what))
        if kind == 'tie' and (bool((path == 2).any()) or
                              not bool((path == 1).any())):
            raise AssertionError('kernel shapes: tie HMM at {} states: a tie '
                                 'did not go to the lower state'.format(
                                     nstates))
        pl = kvit.plan(nstates, ncomp, SHAPE_BATCH)
        c_side = kvit.launch_shape(SHAPE_BATCH, nstates, ncomp)
        if (pl.launch, pl.smem, pl.design) != c_side:
            raise AssertionError(
                'kernel shapes: {} states x {} components: plan launches {} '
                'with {} bytes of dynamic shared memory on the {} design, '
                'the C side {} with {} on the {}'.format(
                    nstates, ncomp, pl.launch, pl.smem, pl.design, *c_side))
        key = (pl.states, pl.components)
        designs[key] = designs.get(key, 0) + 1
    log('kernel shapes: viterbi_extents and viterbi exact (extents, paths, '
        'logp) at {} HMMs of 1 to 8 states x 1 to 5 components, {} states x '
        'components, the tie HMM at 7 and 8 states and past the fast '
        'division\'s range ({}), [{}, {}]; by instantiation <states, '
        'components (0: any)>: {}'.format(
            len(hmms), ', '.join('{} x {}'.format(*c)
                                 for c in SHAPE_MANY_COMPONENTS),
            ', '.join(sorted({kind for kind, _, signal in hmms if signal})),
            SHAPE_BATCH, SHAPE_VITERBI_T,
            json.dumps({'<{},{}>'.format(*k): v
                        for k, v in sorted(designs.items())})))
    return designs


def widened_config(outdir, preset):
    """The main path's options on the widened preset."""
    from poreplex_torch.config import build_config
    return build_config(outdir, outdir, preset=preset, barcoding=True,
                        trim_adapter=True, device='cuda',
                        device_batch_size=BATCH,
                        barcoding_quality_filter=BARCODE_PHRED,
                        measure_polya=True, filter_unsplit_reads=True,
                        mesh_shape=1)


# the widened preset's kernel rows: wrapper -> JSON name, which names the
# kernel function that runs it
WIDENED_ROWS = {
    'lstm2_stacked': 'lstm2_stacked: lstm2_stacked_general_kernel (widened '
                     'preset, LSTM(96) x 2)',
    'bidirectional_lstm': 'bidirectional_lstm: bilstm_kernel<56> (widened '
                          'preset, BiLSTM(56))',
    'lstm_last': 'lstm_last: lstm_general_kernel (widened preset, '
                 'LSTM(128))',
    'viterbi_extents': 'viterbi_extents: viterbi_extents_kernel<8,3> '
                       '(widened preset, 7 states, K 3)',
    'viterbi': 'viterbi: viterbi_path_kernel<8,4> (widened preset, 8 '
               'states, K 4)',
}


def time_widened(preset, rng):
    """Kernels 1 to 5 at the widened preset's full shapes (stage 1 at
    B = 256, the unsplit windows at [1024, 1024]), against their plain
    versions, timed with their bounds and torch.nn.LSTM."""
    from poreplex_torch.pipeline.engine import DeviceEngine
    with tempfile.TemporaryDirectory() as outdir:
        engine = DeviceEngine(widened_config(outdir, preset))
        with torch.inference_mode():
            rows = (check_lstms(engine, rng, ragged=()) +
                    check_viterbi(engine, rng, ragged=()) +
                    check_unsplit_viterbi(engine.unsplitmodel, rng,
                                          ((1024, 1024),)))
    for row in rows:
        row['json_name'] = WIDENED_ROWS[row['name']]
    check_widened_clusters(rows)
    check_widened_bilstm(rows)
    check_widened_viterbis(rows)
    return rows


# the widened rows that run the general design: each must run in clusters
# of at least 2 blocks, with every weight row in shared memory
WIDENED_CLUSTERED = ('lstm2_stacked', 'lstm_last')


def check_widened_clusters(rows):
    """Fails unless the widened LSTM(96) x 2 and LSTM(128) launched in
    clusters of 2 blocks or more that hold every weight row (none read
    from device memory in a step), and the card holds their clusters."""
    for row in rows:
        if row['name'] not in WIDENED_CLUSTERED:
            continue
        widths = row['widths'][1:]
        if not ((row['cluster'] or 0) >= 2 and
                row['smem_rows'] == max(widths) and row['max_clusters']):
            raise AssertionError(
                '{} at {}: cluster {}, {} of {} rows in shared memory, max '
                'active clusters {}'.format(
                    row['json_name'], row['shape'], row['cluster'],
                    row['smem_rows'], max(widths), row['max_clusters']))
        log('kernel shapes: {} ran in clusters of {} blocks (the card holds '
            '{} at once), all {} rows of each matrix in shared memory'.format(
                row['json_name'], row['cluster'], row['max_clusters'],
                max(widths)))


def check_widened_bilstm(rows):
    """Fails unless the widened BiLSTM(56) ran the register kernel at its
    own width with no inert unit: bilstm_kernel<56>, launched once a call
    on the layer's own weights, its [B, T, 2H] output written by the
    kernel (no padded copy before the launch, none after it)."""
    for row in rows:
        if row['name'] != 'bidirectional_lstm':
            continue
        hidden = row['widths'][-1]
        want = {'bilstm_kernel<{}>'.format(hidden): 1}
        if (row['functions'] != want or row['kernel_width'] != hidden or
                row['out_shape'] != row['shape'] + [2 * hidden]):
            raise AssertionError(
                '{} at {}: BiLSTM({}) launched {} at width {}, output {}, '
                'not {} at its own width'.format(
                    row['json_name'], row['shape'], hidden, row['functions'],
                    row['kernel_width'], row['out_shape'], want))
        log('kernel shapes: {} ran bilstm_kernel<{}>, the layer\'s own width '
            '(no inert unit), output {}'.format(row['json_name'], hidden,
                                                row['out_shape']))


# the general design's BiLSTM, which no preset runs: both directions in
# one launch at H 128 from a width-1 input, [B, T]
GENERAL_BILSTM = (BATCH, 300, 128)


@torch.inference_mode()
def time_general_bilstm(rng):
    """lstm_general_kernel's BiLSTM at GENERAL_BILSTM against its plain
    version, timed beside torch.nn.LSTM(bidirectional=True) and its
    bound; returns the row."""
    from poreplex_torch import kernels
    from poreplex_torch.kernels import lstm as klstm
    from poreplex_torch.ops import rnn
    batch, seqlen, hidden = GENERAL_BILSTM
    fwd, bwd = random_layer(rng, 1, hidden), random_layer(rng, 1, hidden)
    xs = torch.as_tensor(rng.normal(0, 1, (batch, seqlen, 1)).astype(
        np.float32), device=DEVICE)
    before = collections.Counter(kernels.instantiations)
    got = klstm.bidirectional_lstm(fwd, bwd, xs)
    functions = dict(kernels.instantiations - before)
    ref, plain_ms = timed(lambda: rnn.bidirectional_lstm(fwd, bwd, xs))
    err = float((got - ref).abs().max())
    if functions != {'lstm_general_kernel<true>': 1} or \
            not err <= LSTM_ATOL:
        raise AssertionError('BiLSTM({}) at {}: launched {}, max abs err {} '
                             'vs plain'.format(hidden, [batch, seqlen],
                                               functions, err))
    net = torch_lstm([[fwd, bwd]], bidirectional=True)
    lib_err = float((net(xs)[0] - got).abs().max())
    library_ms = time_ms(lambda: net(xs), reps=5)
    pl, launch, design, clusters = lstm_plan('bidirectional_lstm', batch, 1,
                                             hidden)
    row = dict(
        name='bidirectional_lstm',
        json_name='bidirectional_lstm: lstm_general_kernel (BiLSTM({}), '
                  'general design)'.format(hidden),
        route='cuda', source='poreplex_torch/csrc/lstm.cu',
        replaces='poreplex_tpu/ops/pallas_rnn.py:236',
        shape=[batch, seqlen], max_abs_err=err,
        ms=time_ms(lambda: klstm.bidirectional_lstm(fwd, bwd, xs), reps=5),
        plain_ms=plain_ms, library_ms=library_ms,
        flops=2 * lstm_flops(batch, seqlen, 1, hidden, 1),
        nbytes=batch * seqlen * 4 + batch * seqlen * 2 * hidden * 4,
        library_err=lib_err, steps=seqlen, step_unit='step', launch=launch,
        design=design, cluster=pl.launches[0].cluster,
        max_clusters=clusters)
    log(kernel_line(row))
    return row


# the widened rows of the Viterbis: the unrolled instantiation each must
# run on the general design
WIDENED_VITERBIS = {'viterbi_extents': 'viterbi_extents_kernel<8,3>',
                    'viterbi': 'viterbi_path_kernel<8,4>'}


def check_widened_viterbis(rows):
    """Fails unless the widened 7-state K 3 extents and 8-state K 4 paths
    ran their unrolled instantiations on the general design (a worker lane
    a state, as the C side reports it), not the loop over K or the shipped
    design."""
    for row in rows:
        want = WIDENED_VITERBIS.get(row['name'])
        if want is None:
            continue
        if row['function'] != want or row['viterbi_design'] != 'general':
            raise AssertionError('{} at {}: ran {} on the {} design, not {} '
                                 'on the general one'.format(
                                     row['json_name'], row['shape'],
                                     row['function'], row['viterbi_design'],
                                     want))
        log('kernel shapes: {} ran {} on the general design (a worker lane '
            'a state)'.format(row['json_name'], want))


def check_kernel_shapes(rng, preset):
    """The "kernel shapes" phase: the grids, then the widened preset's
    kernel rows (returned)."""
    t0 = time.perf_counter()
    check_lstm_shapes(rng)
    check_viterbi_shapes(rng)
    rows = time_widened(preset, rng)
    for row in rows:
        log(kernel_line(row))
    time_general_bilstm(rng)
    log('kernel shapes took {:.1f} s'.format(time.perf_counter() - t0))
    return rows


def kernel_line(row):
    bound_ms, bound_by = bound(row['flops'], row['nbytes'])
    line = ('kernel {name} {shape}: max_err={max_abs_err:.3g} '
            'kernel_ms={ms:.4f} bound_ms={bound:.5f} ({by}) '
            'plain_ms={plain_ms:.2f}{plain_where} library_ms={lib} (library '
            'vs kernel max err {lib_err})'.format(
                plain_where=(' (on the CPU)' if row.get('plain_on') == 'cpu'
                             else ''),
                lib=('{:.4f}'.format(row['library_ms'])
                     if row['library_ms'] is not None else 'none'),
                lib_err=('{:.3g}'.format(row['library_err'])
                         if 'library_err' in row else 'none'),
                bound=bound_ms, by=bound_by, **row))
    if 'steps' in row:
        line += (' per_{}_us={:.4f} launch=(ROWS {}, threads {}, blocks '
                 '{})'.format(row['step_unit'],
                              row['ms'] / row['steps'] * 1e3,
                              *row['launch']))
    if row.get('cluster') is not None:
        line += ' cluster={} max_active_clusters={}'.format(
            row['cluster'], row['max_clusters'])
    if 'design' in row:
        line += ' design: {}'.format(row['design'])
    return line


def make_reads(rng, n):
    """The main path's simulated reads: transcripts of about 200 to 2,000
    nt (43 raw samples a base); one read in TWO_MOLECULES_EVERY holds a
    second leader and adapter."""
    from poreplex_torch import simulate
    return [simulate.simulate_read(
        rng, transcript_len=int(rng.integers(*TRANSCRIPT_SAMPLES)),
        polya_len=int(rng.integers(*POLYA_SAMPLES)), barcode=i % 4,
        **(TWO_MOLECULES if two_molecules(i) else {}))
        for i in range(n)]


def run_main_path(config, rng):
    """512 simulated reads through BatchAnalyzer on the card, written with
    the port's writers. Launch counts and stage timers are reset just
    before the analyzer runs and read just after. Returns (results,
    timings, launches, analyzer, every record's stage-1 input, the
    simulated reads by id, the records and stage-1 outputs of the run,
    the window bucket of each poly(A) round by read id)."""
    from poreplex_torch import kernels, simulate
    from poreplex_torch.io.writers import FASTQWriter, SequencingSummaryWriter
    from poreplex_torch.pipeline.analyzer import BatchAnalyzer
    from poreplex_torch.pipeline.read import ReadRecord
    from poreplex_torch.utils import GLOBAL_TIMER

    analyzer = BatchAnalyzer(config)
    reads = make_reads(rng, N_READS)
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
    # keep the run's stage-1 outputs, which the CPU check replays
    stage1_run = {}
    run_stage1 = analyzer.run_stage1

    def keep_stage1(recs):
        stage1_run['records'] = [rec.read_id for rec in recs]
        stage1_run['outputs'] = run_stage1(recs)
        return stage1_run['outputs']
    analyzer.run_stage1 = keep_stage1
    # and the bucket of every poly(A) round, which the CPU check samples
    polya_blens = {}
    launch = analyzer.polya_analyzer._launch

    def keep_blens(chunk, blen):
        for t in chunk:
            polya_blens.setdefault(t.read.read_id, []).append(blen)
        return launch(chunk, blen)
    analyzer.polya_analyzer._launch = keep_blens

    GLOBAL_TIMER.totals.clear()
    GLOBAL_TIMER.counts.clear()
    kernels.reset_launches()
    t1 = time.perf_counter()
    results, _ = analyzer.process_batch(None, (results, records))
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
    del analyzer.run_stage1
    del analyzer.polya_analyzer._launch
    return (results, timings, launches, analyzer, stage1_inputs,
            {read.read_id: read for read in reads}, stage1_run, polya_blens)


def traced(fn, host=True):
    """fn() under torch.profiler: (its wall ms, the device's kernel and
    copy spans as sorted (start us, end us, name)). host=False traces the
    device alone, which costs a step of some 300,000 launches less. The
    profiler's raw events are read as they are: its Python event tree
    takes minutes to build at that size."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    activities = [ProfilerActivity.CUDA] + \
        ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernels and copies only: the CPU operators' rows would
    # count the same kernels twice, the stage ranges (utils.trace) are
    # projected onto the device timeline as annotations that span idle
    # gaps, and the profiler's own buffer requests are none of the work
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and
                   not e.is_user_annotation() and
                   not e.name().startswith('Activity Buffer'))
    return wall_ms, spans


def busy_ms(spans):
    """The union of the spans' intervals, in ms."""
    busy_us, end = 0.0, float('-inf')
    for start, stop, _ in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy_us / 1e3


def kernel_launches(spans):
    """Device events other than copies and memsets."""
    return sum(not name.startswith(('Memcpy', 'Memset'))
               for _, _, name in spans)


def profile(label, fn, host=True):
    """fn() under torch.profiler (``traced``): wall time, the device's busy
    share (the union of the device's kernel and copy intervals over the
    wall time) and the device time by kernel name. Returns the wall and
    busy ms and the kernel launches."""
    wall_ms, spans = traced(fn, host)
    busy = busy_ms(spans)
    by_name, count = {}, {}
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
        count[name] = count.get(name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ours = sorted((name, us) for name, us in by_name.items()
                  if any(k in name for k in PORT_KERNELS))
    most = sorted(count.items(), key=lambda kv: -kv[1])[:12]
    log('{} profile: wall {:.2f} ms, device busy {:.2f} ms ({:.1%}) in {} '
        'device events; by name: {}; the port\'s kernels: {}; the most '
        'launched: {}'.format(
            label, wall_ms, busy, busy / wall_ms, len(spans),
            '; '.join('{} {:.3f} ms'.format(name[:60], us / 1e3)
                      for name, us in top),
            '; '.join('{} {:.3f} ms ({} launches)'.format(
                name[:60], us / 1e3, count[name]) for name, us in ours),
            '; '.join('{} {}'.format(name[:60], n) for name, n in most)))
    return wall_ms, busy, kernel_launches(spans)


def profile_batch(analyzer, reads):
    """One 256-read batch through the whole analyzer (stage 1, poly(A),
    unsplit filter), its stage timers beside the profile."""
    from poreplex_torch import simulate
    from poreplex_torch.pipeline.read import ReadRecord
    from poreplex_torch.utils import GLOBAL_TIMER
    stopped, records = [], []
    for read in reads:
        rec = ReadRecord('simulated.fast5', analyzer.inputdir, read.read_id)
        analyzer.add_read(rec, simulate.MemoryRead(read), stopped, records)
    GLOBAL_TIMER.totals.clear()
    GLOBAL_TIMER.counts.clear()
    profile('{}-read batch'.format(len(records)),
            lambda: analyzer.process_batch(None, (stopped, records)))
    log('profiled batch stage timers:', json.dumps(GLOBAL_TIMER.snapshot()))


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


def cpu_check_reads(stage1_run, polya_blens, reads):
    """Positions in the run's records of the reads the CPU check replays:
    the first CPU_PER_BUCKET reads of each poly(A) window bucket the run
    used (a read counts in the widest bucket of its rounds), the first read
    whose poly(A) took more than one round, and the first read of two
    molecules."""
    order = {read_id: i for i, read_id in enumerate(reads)}
    picks, per_bucket = [], {}
    multi = fused = False
    for pos, read_id in enumerate(stage1_run['records']):
        blens = polya_blens.get(read_id, [])
        take = False
        if blens and per_bucket.get(max(blens), 0) < CPU_PER_BUCKET:
            per_bucket[max(blens)] = per_bucket.get(max(blens), 0) + 1
            take = True
        if len(blens) > 1 and not multi:
            multi = take = True
        if two_molecules(order[read_id]) and not fused:
            fused = take = True
        if take:
            picks.append(pos)
    return picks, per_bucket


def check_polya_unsplit_against_cpu(config, results, reads, stage1_run,
                                    polya_blens):
    """Reads of the main path from each poly(A) window bucket through the
    same analyzer on the CPU (plain versions of every kernel), given the
    card's stage-1 outputs: each read's poly(A) begin, end and dwell, and
    its status and label (the unsplit decision among them), must be
    equal."""
    from poreplex_torch import simulate
    from poreplex_torch.pipeline.analyzer import BatchAnalyzer
    from poreplex_torch.pipeline.read import ReadRecord
    picks, per_bucket = cpu_check_reads(stage1_run, polya_blens, reads)
    if len(per_bucket) < 2:
        raise AssertionError('CPU check: the main path used poly(A) buckets '
                             '{} only'.format(sorted(per_bucket)))
    cpu = BatchAnalyzer(dict(config, device='cpu'))
    ids = [stage1_run['records'][pos] for pos in picks]
    cpu.run_stage1 = lambda recs: {k: v[picks] for k, v in
                                   stage1_run['outputs'].items()}
    stopped, records = [], []
    for read_id in ids:
        rec = ReadRecord('simulated.fast5', cpu.inputdir, read_id)
        cpu.add_read(rec, simulate.MemoryRead(reads[read_id]), stopped,
                     records)
    if stopped or [rec.read_id for rec in records] != ids:
        raise AssertionError('CPU check: reads did not load as on the card')
    t0 = time.perf_counter()
    got, _ = cpu.process_batch(None, ([], records))
    got = {r['read_id']: r for r in got}
    cpu_s = time.perf_counter() - t0
    card = {r['read_id']: r for r in results}
    tails = unsplit = 0
    for read_id in ids:
        a, b = card[read_id], got[read_id]
        for key in ('status', 'label'):
            if a.get(key) != b.get(key):
                raise AssertionError('read {}: {} {} on the card, {} on the '
                                     'CPU'.format(read_id, key, a.get(key),
                                                  b.get(key)))
        pa, pb = a.get('polya'), b.get('polya')
        if (pa is None) != (pb is None) or (pa is not None and any(
                pa[k] != pb[k] for k in ('begin', 'end', 'dwell_time'))):
            raise AssertionError('read {}: poly(A) {} on the card, {} on '
                                 'the CPU'.format(read_id, pa, pb))
        tails += pa is not None
        unsplit += a['status'] == 'unsplit_read'
    if not tails:
        raise AssertionError('CPU check: no read with a poly(A) tail')
    log('poly(A) and unsplit on cuda == cpu for {} reads (reads by widest '
        'window bucket {}; {} tails, {} unsplit; begin, end, dwell, status '
        'and label equal; {:.1f} s on the CPU)'.format(
            len(ids), json.dumps({str(k): v for k, v in
                                  sorted(per_bucket.items())}),
            tails, unsplit, cpu_s))


def summary_rows(outdir):
    """(header, {read id: row}) of a sequencing_summary.txt."""
    with open(os.path.join(outdir, 'sequencing_summary.txt')) as f:
        rows = f.read().splitlines()
    return rows[0], {row.split('\t')[1]: row for row in rows[1:]}


def fastq_records(outdir):
    """{read id: (FASTQ file, record)} of every FASTQ stream."""
    records = {}
    for root, _, files in os.walk(os.path.join(outdir, 'fastq')):
        for fn in files:
            path = os.path.join(root, fn)
            with gzip.open(path, 'rt') as f:
                lines = f.read().splitlines()
            for i in range(0, len(lines), 4):
                records[lines[i][1:]] = (os.path.relpath(path, outdir),
                                         lines[i:i + 4])
    return records


def run_cli(argv, source):
    """commandline.main on argv from ``source`` with the launch counts and
    stage timers reset just before: (result, wall seconds from main
    entered to main returned, launches, stage timers)."""
    from poreplex_torch import commandline, kernels
    from poreplex_torch.utils import GLOBAL_TIMER
    args = commandline.parse_args(argv)
    GLOBAL_TIMER.totals.clear()
    GLOBAL_TIMER.counts.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = commandline.main(args, source=source)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    return (result, wall_s, dict(kernels.launches),
            GLOBAL_TIMER.snapshot())


def session_through_cli(config, results, reads, main_outdir, card):
    """The main path's reads, from memory, through the port's command line
    on the card at batches of BATCH (two batches), with the main path's
    options: every kernel of the main path launches, the outputs pass
    check_outputs and each read's summary row and FASTQ record equal the
    main path's; the manifest lists every okay read. Resumed over the same
    output, as in poreplex-tpu the summary is written anew: a run over the
    same reads holds the rows of the reads that were not okay, analysed
    again, and a run over the okay reads launches no kernel, keeps the
    manifest and leaves a header-only summary. ``python -m poreplex_torch
    --version`` exits with 0."""
    from poreplex_torch.pipeline.source import MemorySource
    source = MemorySource(list(reads.values()))
    with tempfile.TemporaryDirectory() as tmp:
        indir, outdir = os.path.join(tmp, 'in'), os.path.join(tmp, 'out')
        os.makedirs(indir)
        argv = ['-i', indir, '-o', outdir, '-y', '-q', '--barcoding',
                '--barcoding-quality-filter', str(BARCODE_PHRED), '--polya',
                '--filter-chimera', '--trim-adapter', '--batch-size',
                str(BATCH), '--device-batch-size', str(BATCH),
                '--mesh-shape', '1']
        result, wall_s, launches, stages = run_cli(argv, source)
        if result is None:
            raise AssertionError('the CLI session did not finish')
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError('the CLI session never launched: {}'.format(
                missing))
        batches = stages['B:device_stage1']['calls']
        if batches != N_READS // BATCH:
            raise AssertionError('the CLI session ran {} batches'.format(
                batches))
        rate = N_READS / wall_s
        log('session through the CLI: {} reads in {} batches, {:.1f} reads/s '
            '({:.3f} s from main entered to main returned, writers '
            'included); {}'.format(N_READS, batches, rate, wall_s, card))
        log('session through the CLI: launches', json.dumps(launches))
        log('session through the CLI: stage timers', json.dumps(stages))
        graphs = {name: stages.get(name, {}).get('count', 0)
                  for name in GRAPH_COUNTERS}
        log('session through the CLI: poly(A) graphs', json.dumps(graphs))
        if (graphs['C:polya/graph_capture'] + graphs['C:polya/graph_replay']
                != stages['C:polya/launch']['calls']):
            raise AssertionError('the CLI session\'s poly(A) launches did '
                                 'not all run a graph: {}'.format(graphs))

        check_outputs(config, results, outdir)
        header, rows = summary_rows(outdir)
        ref_header, ref_rows = summary_rows(main_outdir)
        if header != ref_header or rows != ref_rows:
            differ = sorted(k for k in set(rows) | set(ref_rows)
                            if rows.get(k) != ref_rows.get(k))
            raise AssertionError('summary rows of {} reads differ from the '
                                 'main path\'s, e.g. {}'.format(
                                     len(differ), differ[:3]))
        fastq, ref_fastq = fastq_records(outdir), fastq_records(main_outdir)
        if fastq != ref_fastq:
            differ = sorted(k for k in set(fastq) | set(ref_fastq)
                            if fastq.get(k) != ref_fastq.get(k))
            raise AssertionError('FASTQ records of {} reads differ from the '
                                 'main path\'s, e.g. {}'.format(
                                     len(differ), differ[:3]))
        manifest_path = os.path.join(outdir, '.processed-reads')
        with open(manifest_path, 'rb') as f:
            manifest = f.read()
        listed = [line.split('\t') for line in manifest.decode().splitlines()]
        okay = sorted(r['read_id'] for r in results if r['status'] == 'okay')
        if sorted(read_id for _, read_id in listed) != okay or any(
                name != MemorySource.FILENAME for name, _ in listed):
            raise AssertionError('.processed-reads does not list the {} okay '
                                 'reads'.format(len(okay)))
        if not os.path.isfile(os.path.join(outdir, 'poreplex.log')):
            raise AssertionError('no poreplex.log')
        log('session through the CLI: {} summary rows and {} FASTQ records '
            'equal to the main path\'s; {} okay reads in .processed-reads'
            .format(len(rows), len(fastq), len(listed)))

        # the manifest holds the okay reads only, as poreplex-tpu's does: a
        # resumed run over the same source analyses the others again, and
        # one over the okay reads alone analyses none
        again = sorted(set(ref_rows) - set(okay))
        result, resume_s, launches, _ = run_cli(argv + ['--resume'], source)
        resumed_header, resumed_rows = summary_rows(outdir)
        if result is None or resumed_header != header or \
                resumed_rows != {k: ref_rows[k] for k in again}:
            raise AssertionError('the resumed run wrote {} rows, not the {} '
                                 'reads that were not okay'.format(
                                     len(resumed_rows), len(again)))
        log('session through the CLI: resumed over the same reads in {:.3f} '
            's: the {} reads that were not okay analysed again (rows equal '
            'to the main path\'s; launches {})'.format(
                resume_s, len(again), json.dumps(launches)))
        done = MemorySource([reads[read_id] for read_id in okay])
        result, resume_s, launches, _ = run_cli(argv + ['--resume'], done)
        resumed_header, resumed_rows = summary_rows(outdir)
        if result is None or any(launches.values()):
            raise AssertionError('the resumed run: result {}, launches '
                                 '{}'.format(result, launches))
        with open(manifest_path, 'rb') as f:
            if f.read() != manifest:
                raise AssertionError('the resumed runs changed the manifest')
        if resumed_header != header or resumed_rows:
            raise AssertionError('the resumed run\'s summary holds {} rows'
                                 .format(len(resumed_rows)))
        log('session through the CLI: resumed over the {} okay reads in '
            '{:.3f} s, no launch, manifest unchanged, header-only summary '
            '(as poreplex-tpu\'s)'.format(len(okay), resume_s))

    out = subprocess.run([sys.executable, '-m', 'poreplex_torch',
                          '--version'], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         timeout=120)
    if out.returncode != 0:
        raise AssertionError('python -m poreplex_torch --version exited {}: '
                             '{}'.format(out.returncode, out.stderr))
    log('python -m poreplex_torch --version: {}'.format(
        out.stdout.splitlines()[0]))
    return rate


# ------------------------------------------- session, widened preset

# the kernel functions the widened preset's session must launch, and no
# other: the scaler's two LSTM(96) in one launch and the LSTM(128) on the
# general design (the scaler's layer 1 folds its width-1 input), BiLSTM(56)
# on the register design at its own width (bilstm_kernel<56>, no inert
# unit), the 7- and 8-state HMMs on the 8-state kernels unrolled for their
# 3 and 4 components
WIDENED_FUNCTIONS = ('lstm2_stacked_general_kernel<true>',
                     'lstm_general_kernel<false>',
                     'bilstm_kernel<56>', 'viterbi_extents_kernel<8,3>',
                     'viterbi_path_kernel<8,4>', 'peaks_kernel', 'dp_kernel')
# reads of the widened session held against the port's CPU session
WIDENED_CPU_READS = 4
# the generator of the kernel-shapes phase, apart from the main path's
SHAPES_SEED = SEED + 5


def session_widened(preset, reads, shipped, card):
    """The main path's reads, from memory, through commandline.main on the
    card with ``-c`` the widened preset and the main path's options: every
    wrapper launches, on the widened kernels alone; then the first
    WIDENED_CPU_READS reads through the port's CPU session (--cpu) on the
    same preset: their summary rows (status, label, barcode, poly(A)
    dwell) and FASTQ records (trimmed at the adapter's extent) equal the
    card session's, and their stage-1 outputs on the card equal the
    CPU's (extents, QC and demux decisions exactly, scaling and demux
    probabilities within LSTM_ATOL). Returns the session's launches."""
    from poreplex_torch import kernels, simulate
    from poreplex_torch.pipeline.analyzer import BatchAnalyzer
    from poreplex_torch.pipeline.read import ReadRecord
    from poreplex_torch.pipeline.source import MemorySource
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        indir = os.path.join(tmp, 'in')
        os.makedirs(indir)

        def argv(outdir):
            return ['-i', indir, '-o', outdir, '-y', '-q', '-c', preset,
                    '--barcoding', '--barcoding-quality-filter',
                    str(BARCODE_PHRED), '--polya', '--filter-chimera',
                    '--trim-adapter', '--batch-size', str(BATCH),
                    '--device-batch-size', str(BATCH), '--mesh-shape', '1']
        outdir = os.path.join(tmp, 'card')
        result, wall_s, launches, stages = run_cli(
            argv(outdir), MemorySource(list(reads.values())))
        functions = dict(kernels.instantiations)
        if result is None:
            raise AssertionError('the widened session did not finish')
        missing = [k for k, v in launches.items() if v == 0]
        if missing or set(functions) != set(WIDENED_FUNCTIONS):
            raise AssertionError('the widened session launched {} (wrappers '
                                 'never launched: {})'.format(functions,
                                                              missing))
        header, rows = summary_rows(outdir)
        labels = {}
        for row in rows.values():
            label = row.split('\t')[header.split('\t').index('label')]
            labels[label] = labels.get(label, 0) + 1
        if len(rows) < 0.95 * N_READS or labels.get('pass', 0) < \
                0.9 * N_READS:
            raise AssertionError('the widened session wrote {} rows, labels '
                                 '{}'.format(len(rows), labels))
        log('session, widened preset: {} reads in {} batches, {:.1f} reads/s '
            '({:.3f} s from main entered to main returned) against {:.1f} '
            'reads/s through the CLI on the shipped preset in this run; '
            'labels {}; {}'.format(
                N_READS, stages['B:device_stage1']['calls'], N_READS / wall_s,
                wall_s, shipped, json.dumps(labels), card))
        log('session, widened preset: launches', json.dumps(launches))
        log('session, widened preset: launches by kernel function',
            json.dumps(functions))
        log('session, widened preset: stage timers', json.dumps(stages))

        ids = list(reads)[:WIDENED_CPU_READS]
        cpu_out = os.path.join(tmp, 'cpu')
        t1 = time.perf_counter()
        cpu_result, _, cpu_launches, _ = run_cli(
            argv(cpu_out) + ['--cpu'],
            MemorySource([reads[read_id] for read_id in ids]))
        cpu_s = time.perf_counter() - t1
        cpu_header, cpu_rows = summary_rows(cpu_out)
        want = {k: rows[k] for k in ids if k in rows}
        if cpu_result is None or any(cpu_launches.values()) or \
                cpu_header != header or cpu_rows != want:
            raise AssertionError('the CPU session\'s summary rows differ from '
                                 'the card\'s: {} against {}'.format(
                                     cpu_rows, want))
        fastq, cpu_fastq = fastq_records(outdir), fastq_records(cpu_out)
        if cpu_fastq != {k: fastq[k] for k in ids if k in fastq}:
            raise AssertionError('the CPU session\'s FASTQ records differ '
                                 'from the card\'s')
        log('session, widened preset: {} reads on the CPU ({:.1f} s): {} '
            'summary rows and {} FASTQ records equal to the card\'s'.format(
                len(ids), cpu_s, len(cpu_rows), len(cpu_fastq)))

        config = widened_config(tmp, preset)
        analyzer = BatchAnalyzer(config)
        stopped, records = [], []
        for read_id in ids:
            rec = ReadRecord('simulated.fast5', analyzer.inputdir, read_id)
            analyzer.add_read(rec, simulate.MemoryRead(reads[read_id]),
                              stopped, records)
        frames = analyzer.engine.seg_frames
        check_against_cpu(config, analyzer, [
            (r.pooled, min(len(r.pooled), frames), r.head_len)
            for r in records])
    log('session, widened preset took {:.1f} s'.format(
        time.perf_counter() - t0))
    return launches


# ----------------------------------------------------- host stages

HOST_PACKAGES = ('albacore', 'mappy', 'pysam')
# poreplex-tpu's messages when a host stage's package is missing
ABSENT_MESSAGES = {
    '--basecall': 'ERROR: On-the-fly basecalling (--basecall) requires the '
                  'ONT albacore package.',
    '--align': 'ERROR: Real-time alignment (--align) requires mappy and '
               'pysam.',
}
# the stand-in albacore's configuration template
ALBACORE_TEMPLATE = ('[pipeline]\nbasecall_type = 1d\n\n[basecaller]\n'
                     'model = template_rna_r9.4_70bps.jsn\nmin_qscore = 7\n')


def importable(name):
    import importlib
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


def write_mmi(path, contigs):
    """A minimap2 .mmi header (w 10, k 15) naming ``contigs``."""
    import struct
    with open(path, 'wb') as f:
        f.write(b'MMI\2')
        f.write(struct.pack('<IIIII', 10, 15, 14, len(contigs), 0))
        for name, seq in contigs.items():
            f.write(bytes([len(name)]) + name.encode() +
                    struct.pack('<I', len(seq)))
    return path


class StandIns:
    """chip_smoke's own stand-ins of albacore, mappy, pysam and curses,
    put in sys.modules by ``install`` and taken out by ``remove``.

    - albacore's PipelineCore finds each read by its signal, which must be
      range / digitisation * (raw + offset) in float32 bit for bit, and
      returns the read's own simulated basecall in albacore's form (DNA,
      3' to 5'); ``calls`` records (name, read id or None, metadata);
    - mappy's Aligner maps a query to the contig whose sequence holds it
      (full length, forward), else to none; ``queries`` records them;
    - pysam writes SAM text;
    - curses draws into a list."""

    def __init__(self, reads, contigs, datadir):
        import types
        from poreplex_torch import simulate
        self.reads = reads
        self.contigs = contigs
        self.calls = []
        self.queries = []
        self.by_signal = {
            np.asarray(simulate.RANGE / simulate.DIGITISATION *
                       (read.raw_dac + simulate.OFFSET),
                       np.float32).tobytes(): read
            for read in reads.values()}
        os.makedirs(datadir, exist_ok=True)
        template = os.path.join(datadir, 'rna.cfg')
        with open(template, 'w') as f:
            f.write(ALBACORE_TEMPLATE)
        stand_ins = self

        class PipelineCore:
            def __init__(self, configpath, workers):
                self.results = []

            def pass_data(self, name, rawdata, meta):
                read = None
                if isinstance(rawdata, np.ndarray) and \
                        rawdata.dtype == np.float32:
                    read = stand_ins.by_signal.get(rawdata.tobytes())
                stand_ins.calls.append(
                    (name, read and read.read_id, dict(meta)))
                self.results = [] if read is None else [{
                    'sequence': read.sequence.replace('U', 'T')[::-1],
                    'qstring': read.qstring[::-1],
                    'mean_qscore': simulate.MEAN_QSCORE,
                    'events': read.events.copy()}]

            def finish_all_jobs(self):
                pass

            def get_results(self):
                results, self.results = self.results, []
                return results

        class Hit:
            def __init__(self, ctg, r_st, qlen):
                self.ctg, self.r_st, self.q_st, self.q_en = ctg, r_st, 0, qlen
                self.strand, self.mapq, self.NM = 1, 60, 0
                self.cigar_str = '{}M'.format(qlen)
                self.is_primary = True

        class Aligner:
            def __init__(self, indexfile):
                pass

            def map(self, seq):
                stand_ins.queries.append(seq)
                for name, contig in stand_ins.contigs.items():
                    at = contig.find(seq)
                    if at >= 0:
                        return iter([Hit(name, at, len(seq))])
                return iter([])

        class AlignmentFile:
            def __init__(self, path, mode, header):
                self.header = header
                self.file = open(path, 'w')
                for sq in header['SQ']:
                    self.file.write('@SQ\tSN:{SN}\tLN:{LN}\n'.format(**sq))

            def write(self, segment):
                self.file.write(segment + '\n')

            def close(self):
                self.file.close()

        class Screen:
            def __getattr__(self, name):
                return lambda *args: None

            def getch(self):
                return -1

            def getmaxyx(self):
                return 24, 100

        def package(name, **attrs):
            module = types.ModuleType(name)
            module.__dict__.update(attrs)
            return module
        albacore = package('albacore', __version__='2.3.4', MIN_QSCORE=7,
                           __path__=[])
        self.modules = {
            'albacore': albacore,
            'albacore.config_utils': package(
                'albacore.config_utils',
                get_barcoding_options=lambda *args: {}),
            'albacore.path_utils': package(
                'albacore.path_utils',
                get_default_path=lambda default, argv: datadir),
            'albacore.config_selector': package(
                'albacore.config_selector',
                choose_config=lambda path, flowcell, kit: (template, 'rna')),
            'albacore.pipeline_core': package(
                'albacore.pipeline_core', PipelineCore=PipelineCore),
            'mappy': package('mappy', Aligner=Aligner, revcomp=lambda seq:
                             seq.translate(str.maketrans('ACGT', 'TGCA'))[
                                 ::-1]),
            'pysam': package(
                'pysam', AlignmentFile=AlignmentFile,
                AlignedSegment=package(
                    'AlignedSegment',
                    fromstring=lambda line, header: line)),
            'curses': package(
                'curses', initscr=Screen, noecho=lambda: None,
                cbreak=lambda: None, nocbreak=lambda: None,
                echo=lambda: None, endwin=lambda: None, KEY_LEFT=260,
                KEY_RIGHT=261, A_REVERSE=0),
        }
        for name, module in self.modules.items():
            if '.' in name:
                setattr(albacore, name.split('.')[1], module)
        self.saved = {}

    def install(self):
        self.saved = {name: sys.modules.get(name) for name in self.modules}
        sys.modules.update(self.modules)

    def remove(self):
        for name, module in self.saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def refusals(source, tmp, mmi):
    """Stage (a): with each host-stage package that does not import here,
    commandline.main stops --basecall or --align with poreplex-tpu's
    message and a non-zero exit, before any read is read."""
    import contextlib
    import io
    present = {name: importable(name) for name in HOST_PACKAGES}
    log('host stages: importable on this host: {}'.format(json.dumps(
        present)))
    options = []
    if not present['albacore']:
        options.append(['--basecall'])
    if not (present['mappy'] and present['pysam']):
        options.append(['--align', mmi])
    for i, option in enumerate(options):
        indir = os.path.join(tmp, 'refused-in')
        outdir = os.path.join(tmp, 'refused-{}'.format(i))
        os.makedirs(indir, exist_ok=True)
        err = io.StringIO()
        code = None
        with contextlib.redirect_stderr(err):
            try:
                run_cli(['-i', indir, '-o', outdir, '-y', '-q'] + option,
                        source)
            except SystemExit as exc:
                code = exc.code
        last = (err.getvalue().strip().splitlines() or [''])[-1]
        from poreplex_torch import kernels
        if code in (0, None) or last != ABSENT_MESSAGES[option[0]] or \
                any(kernels.launches.values()) or os.path.exists(
                    os.path.join(outdir, 'sequencing_summary.txt')):
            raise AssertionError('{} without its package: exit {}, {!r}'
                                 .format(option[0], code, last))
        log('host stages: {} stops with exit {} before any read: {}'.format(
            option[0], code, last))
    if not options:
        log('host stages: every package imports here; no refusal to run')


def expected_alignment(results, contigs):
    """(the aligner's queries, {barcode: (mapped, unmapped, failed)}) the
    main path's reports give: a read with a sequence is mapped, its 3'
    adapter trimmed, in the DNA alphabet."""
    queries = []
    tallies = {}
    for r in results:
        counts = tallies.setdefault(r.get('barcode'), [0, 0, 0])
        if r.get('sequence') is None:
            counts[2] += 1
            continue
        seq, _, adapter = r['sequence']
        query = (seq[:-adapter] if adapter > 0 else seq).replace('U', 'T')
        queries.append(query)
        counts[0 if any(query in c for c in contigs.values()) else 1] += 1
    return queries, {k: tuple(v) for k, v in tallies.items()}


def host_stages_through_cli(config, results, reads, main_outdir, card):
    """Stage (a), refusals, then (b): the main path's reads from memory
    through commandline.main on the card with --basecall, --align,
    --fastq and --dashboard (and the main path's options) on chip_smoke's
    stand-ins. Every summary row and FASTQ record equals the main path's;
    albacore gets each read that reached PHASE C once, its signal bit for
    bit; every read with a sequence reaches the aligner once, adapter
    trimmed; each BAM stream holds exactly its reads' rows; the dashboard's
    tallies equal the counts; every kernel launches."""
    import contextlib
    import io
    from poreplex_torch import dashboard, simulate
    from poreplex_torch.pipeline.session import ProcessingSession
    from poreplex_torch.pipeline.source import MemorySource
    source = MemorySource(list(reads.values()))
    # every other read with a sequence lies in a contig
    contigs = {}
    for i, r in enumerate(results):
        if r.get('sequence') is not None and i % 2 == 0:
            seq, _, adapter = r['sequence']
            query = (seq[:-adapter] if adapter > 0 else seq)
            contigs['tx{}|{}'.format(i, r['read_id'][:8])] = \
                'GATTACA' + query.replace('U', 'T') + 'CCGG'
    with tempfile.TemporaryDirectory() as tmp:
        mmi = write_mmi(os.path.join(tmp, 'ref.mmi'), contigs)
        refusals(source, tmp, mmi)

        stand_ins = StandIns(reads, contigs, os.path.join(tmp, 'albacore'))
        log('host stages: stand-ins of {} installed (chip_smoke\'s own, not '
            'the packages)'.format(', '.join(sorted(stand_ins.modules))))
        sessions = []
        start_dashboard = ProcessingSession.start_dashboard

        def keep_session(sess):
            sessions.append(sess)
            return start_dashboard(sess)
        indir, outdir = os.path.join(tmp, 'in'), os.path.join(tmp, 'out')
        os.makedirs(indir)
        argv = ['-i', indir, '-o', outdir, '-y', '--barcoding',
                '--barcoding-quality-filter', str(BARCODE_PHRED), '--polya',
                '--filter-chimera', '--trim-adapter', '--batch-size',
                str(BATCH), '--device-batch-size', str(BATCH),
                '--mesh-shape', '1', '--basecall', '--align', mmi, '--fastq',
                '--dashboard']
        printed = io.StringIO()
        stand_ins.install()
        ProcessingSession.start_dashboard = keep_session
        try:
            with contextlib.redirect_stdout(printed):
                result, wall_s, launches, stages = run_cli(argv, source)
        finally:
            ProcessingSession.start_dashboard = start_dashboard
            stand_ins.remove()
        if result is None or len(sessions) != 1:
            raise AssertionError('the host-stage session did not finish '
                                 '(dashboards started: {})'.format(
                                     len(sessions)))
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError('the host-stage session never launched: '
                                 '{}'.format(missing))
        log('host stages: {} reads, {:.1f} reads/s ({:.3f} s from main '
            'entered to main returned); {}'.format(
                N_READS, N_READS / wall_s, wall_s, card))
        log('host stages: launches', json.dumps(launches))
        log('host stages: D:io_AlignmentWriter.process {}, C:albacore {}, '
            'C:events_trim {}'.format(*(
                json.dumps(stages.get(name)) for name in (
                    'D:io_AlignmentWriter.process', 'C:albacore',
                    'C:events_trim'))))

        # the same rows and records as the main path's; albacore's calls
        # are RNA (U), the simulated files' basecalls are written in T
        header, rows = summary_rows(outdir)
        ref_header, ref_rows = summary_rows(main_outdir)
        fastq, ref_fastq = fastq_records(outdir), fastq_records(main_outdir)
        in_t = {read_id: (path, [lines[0], lines[1].replace('U', 'T')] +
                          lines[2:])
                for read_id, (path, lines) in fastq.items()}
        for what, got, ref in (('summary rows', (header, rows),
                                (ref_header, ref_rows)),
                               ('FASTQ records (U as T)', in_t, ref_fastq)):
            if got != ref:
                raise AssertionError('{} with --basecall differ from the '
                                     'main path\'s: {} against {}'.format(
                                         what, str(got)[:300],
                                         str(ref)[:300]))
        # albacore: each read that reached PHASE C once, under its file's
        # name, its signal found bit for bit
        called = sorted(read_id for _, read_id, _ in stand_ins.calls)
        with_sequence = sorted(r['read_id'] for r in results
                               if r.get('sequence') is not None)
        if called != with_sequence or any(
                name != 'simulated' for name, _, _ in stand_ins.calls):
            raise AssertionError('albacore got {} reads ({} not found by '
                                 'their signal), {} have sequences'.format(
                                     len(called), called.count(None),
                                     len(with_sequence)))
        for _, read_id, meta in stand_ins.calls:
            read = reads[read_id]
            if meta != {'channel_id': read.channel,
                        'start_time': read.start_time,
                        'duration': read.duration,
                        'sampling_rate': simulate.SAMPLING_RATE}:
                raise AssertionError('albacore metadata of {}: {}'.format(
                    read_id, meta))
        # the aligner: every read with a sequence once, adapter trimmed
        queries, tallies = expected_alignment(results, contigs)
        if sorted(stand_ins.queries) != sorted(queries):
            raise AssertionError('the aligner got {} queries for {} reads '
                                 'with sequences'.format(
                                     len(stand_ins.queries), len(queries)))
        # each BAM stream holds exactly its reads' rows
        streams = {}
        for row in rows.values():
            fields = dict(zip(header.split('\t'), row.split('\t')))
            if fields['read_id'] in fastq:
                streams.setdefault(os.path.join(
                    fields['label'], fields['barcode']), set()).add(
                        fields['read_id'])
        bam_reads = 0
        for name in config['output_layout'].values():
            with open(os.path.join(outdir, 'bam', name + '.bam')) as f:
                sam = [line.split('\t') for line in f.read().splitlines()
                       if not line.startswith('@')]
            names = [fields[0] for fields in sam]
            if sorted(names) != sorted(streams.get(name, ())):
                raise AssertionError('bam/{}.bam holds {} rows for {} '
                                     'reads'.format(name, len(names),
                                                    len(streams.get(name,
                                                                    ()))))
            for fields in sam:
                mapped = fields[2] != '*'
                if fields[1] != ('0' if mapped else '4') or \
                        fields[9] != fastq[fields[0]][1][1].replace(
                            'U', 'T') or \
                        (mapped and fields[9] not in contigs[fields[2]]):
                    raise AssertionError('bam/{}.bam: {}'.format(
                        name, fields[:6]))
            bam_reads += len(names)
        # the dashboard's tallies
        view = sessions[0].dashboard
        got = {group: (view.stats.total[group], view.stats.unmapped[group],
                       view.stats.failed[group])
               for group in set(tallies) | set(view.stats.groups())}
        if got != tallies:
            raise AssertionError('dashboard tallies {} for counts {}'.format(
                got, tallies))
        # the group with the most mapped reads on the screen
        groups = view.stats.groups()
        view.selected_group = max(range(len(groups)),
                                  key=lambda i: view.stats.total[groups[i]])
        snapshot = dashboard.render_dashboard(view.snapshot_state(), 100, 16)
    log('host stages: {} summary rows and {} FASTQ records (U as T) equal '
        'to the main path\'s; albacore called {} times, signals bit for '
        'bit; {} queries; {} BAM rows in {} streams; tallies {} (barcode: mapped, '
        'unmapped, failed); {} lines printed by the CLI'.format(
            len(rows), len(fastq), len(stand_ins.calls), len(queries),
            bam_reads, len(config['output_layout']),
            json.dumps({str(k): v for k, v in sorted(
                tallies.items(), key=lambda kv: str(kv[0]))}),
            len(printed.getvalue().splitlines())))
    log('host stages: the dashboard of the finished session; {}'.format(
        card))
    for row in snapshot:
        log('  | ' + row)


# the ingest turns: -p of each run, in turns, each from a fresh session
INGEST_TURNS = (1, 2, 4, 1)
INGEST_TIMEOUT = 300


def ingest_argv(indir, outdir, parallel):
    return rank_argv(indir, outdir) + ['-p', str(parallel)]


def ingest_main(argv):
    """The ingest turns, in a process of their own started by
    check_ingest_turns: ``WORKDIR MAIN_OUTDIR``. Takes the main path's
    reads from WORKDIR/reads.pickle, warms the card up, then runs them
    from memory through commandline.main once for each -p of
    INGEST_TURNS: every kernel launches, every summary row and FASTQ
    record equals the main path's, -p N (N >= 2) starts N workers that
    import neither torch nor jax and -p 1 none. Writes WORKDIR/turns.json.
    (Its own process, started with -c: a spawned worker imports the main
    module of the process that spawns it unless that is run with -c or
    -m, and this script's imports torch.)"""
    import pickle
    from poreplex_torch.config import build_config
    from poreplex_torch.pipeline import ingest
    from poreplex_torch.pipeline.analyzer import BatchAnalyzer
    from poreplex_torch.pipeline.source import MemorySource
    work, main_outdir = argv
    with open(os.path.join(work, 'reads.pickle'), 'rb') as f:
        reads = pickle.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        warm = BatchAnalyzer(build_config(
            tmp, tmp, barcoding=True, trim_adapter=True, mesh_shape=1,
            measure_polya=True, filter_unsplit_reads=True))
        warm.process_batch(None, mesh_records(warm, reads[:16]))
        del warm
    torch.cuda.synchronize()

    pings = []
    warm_pool = ingest.IngestPool.warm

    def recording_warm(pool):
        ping = warm_pool(pool)
        pings.append((pool.worker_pids(), ping))
        return ping
    ingest.IngestPool.warm = recording_warm
    ref_header, ref_rows = summary_rows(main_outdir)
    ref_fastq = fastq_records(main_outdir)
    turns = []
    for i, parallel in enumerate(INGEST_TURNS):
        indir = os.path.join(work, 'in')
        outdir = os.path.join(work, 'out-{}'.format(i))
        os.makedirs(indir, exist_ok=True)
        del pings[:]
        result, wall_s, launches, stages = run_cli(
            ingest_argv(indir, outdir, parallel), MemorySource(reads))
        where = '-p {} (turn {})'.format(parallel, i)
        if result is None:
            raise AssertionError(where + ': the session did not finish')
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError('{}: never launched {}'.format(where,
                                                                missing))
        header, rows = summary_rows(outdir)
        if header != ref_header or rows != ref_rows:
            raise AssertionError(where + ': summary rows differ from the '
                                 'main path\'s')
        if fastq_records(outdir) != ref_fastq:
            raise AssertionError(where + ': FASTQ records differ from the '
                                 'main path\'s')
        workers = [pid for pids, _ in pings for pid in pids]
        packages = [names for _, ping in pings for _, names in ping]
        if len(workers) != (parallel if parallel >= 2 else 0) or any(
                'torch' in names or 'jax' in names for names in packages):
            raise AssertionError('{}: workers {}, packages {}'.format(
                where, workers, packages))
        turns.append({'parallel': parallel, 'wall_s': wall_s,
                      'launches': launches, 'stages': stages,
                      'workers': len(workers), 'reads': len(reads),
                      'rows': len(rows)})
    with open(os.path.join(work, 'turns.json'), 'w') as f:
        json.dump(turns, f)
    return 0


def check_ingest_turns(reads, main_outdir, card):
    """The main path's reads from memory through the command line with -p
    1, 2, 4 and 1 in turns (ingest_main, in a process of its own): reads/s
    from main entered to main returned, A:fast5_load and its A:* parts
    (with workers, a part's time is the largest of the batch's chunks'),
    S:build_analyzer (which starts the workers), launches, and the host's
    CPU count. These reads come from memory: the card's host reads no
    FAST5 (no libhdf5), so no line here times FAST5 ingest."""
    import pickle
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, 'reads.pickle'), 'wb') as f:
            pickle.dump(list(reads.values()), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        log('ingest turns: the {} reads pickle to {:.1f} MB (what a '
            'MemorySource sends each worker)'.format(
                len(reads), os.path.getsize(f.name) / 1e6))
        code = ('import sys, chip_smoke; '
                'sys.exit(chip_smoke.ingest_main(sys.argv[1:]))')
        with open(os.path.join(work, 'log'), 'w') as logf:
            proc = subprocess.Popen(
                [sys.executable, '-c', code, work, main_outdir],
                stdout=logf, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            try:
                code = proc.wait(timeout=INGEST_TIMEOUT)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if code != 0:
            with open(os.path.join(work, 'log')) as f:
                log('ingest turns log:\n' + f.read()[-3000:])
            raise AssertionError('the ingest turns exited with {}'.format(
                code))
        with open(os.path.join(work, 'turns.json')) as f:
            turns = json.load(f)
    for turn in turns:
        stages = turn['stages']
        parts = {name: stages[name]['total_s'] for name in
                 ('A:open', 'A:raw', 'A:pool', 'A:bcall')}
        log('ingest -p {}: {} reads ({} summary rows), {:.1f} reads/s '
            '({:.3f} s from main entered to main returned); {} workers; '
            'A:fast5_load {:.4f} s ({} batches), parts {}; '
            'S:build_analyzer {:.4f} s; B:device_stage1 {:.4f} s, C:polya '
            '{:.4f} s; launches {}; os.cpu_count() {}; reads from memory; '
            '{}'.format(
                turn['parallel'], turn['reads'], turn['rows'],
                turn['reads'] / turn['wall_s'], turn['wall_s'],
                turn['workers'], stages['A:fast5_load']['total_s'],
                stages['A:fast5_load']['calls'], json.dumps(parts),
                stages['S:build_analyzer']['total_s'],
                stages['B:device_stage1']['total_s'],
                stages['C:polya']['total_s'],
                json.dumps(turn['launches']), os.cpu_count(), card))
    log('ingest turns: every kernel launched in each, summary rows and '
        'FASTQ records equal to the main path\'s, -p N started N workers '
        'that imported neither torch nor jax, -p 1 none')


def native_reader_line():
    """Builds the native FAST5 reader with g++ and says whether libhdf5
    opens for it; never fails."""
    from poreplex_torch import fast5_native
    t0 = time.perf_counter()
    try:
        path = fast5_native.build_library()
    except (OSError, subprocess.CalledProcessError) as exc:
        return 'native FAST5 reader: not built ({})'.format(exc)
    built_s = time.perf_counter() - t0
    lib = fast5_native.get_library()
    return ('native FAST5 reader: built {} with g++ in {:.1f} s; {}'.format(
        os.path.relpath(path, os.path.dirname(os.path.abspath(__file__))),
        built_s,
        'libhdf5 opened for it' if lib is not None else
        'no libhdf5 opens on this host, so FAST5 ingest is held by the CPU '
        'tests only (tests/test_torch_fast5_native.py, '
        'tests/test_torch_ingest.py)'))


def polya_summary(results, timings, reads, polya_blens):
    """Call rate and dwell against each read's simulated tail, and the
    rounds the main path ran per window bucket."""
    from poreplex_torch.simulate import SAMPLING_RATE
    passed = [r for r in results if r.get('label') == 'pass']
    dwell, truth = [], []
    for r in passed:
        if 'polya' in r:
            begin, end = reads[r['read_id']].segments['polya-tail']
            dwell.append(r['polya']['dwell_time'])
            truth.append((end - begin + 1) / SAMPLING_RATE)
    if not dwell:
        raise AssertionError('no pass read has a poly(A) tail')
    ratio = np.asarray(dwell) / np.asarray(truth)
    log('poly(A): {} of {} pass reads have a tail ({:.1%}), median dwell '
        '{:.4f} s against a median simulated tail of {:.4f} s ({} to {} '
        'samples at {} Hz); dwell / simulated tail: median {:.4f}, 10th '
        'and 90th percentiles {:.4f} and {:.4f}'.format(
            len(dwell), len(passed), len(dwell) / len(passed),
            float(np.median(dwell)), float(np.median(truth)),
            POLYA_SAMPLES[0], POLYA_SAMPLES[1] - 1, int(SAMPLING_RATE),
            float(np.median(ratio)), *np.percentile(ratio, [10, 90])))
    windows, widest = {}, {}
    for blens in polya_blens.values():
        for blen in blens:
            windows[blen] = windows.get(blen, 0) + 1
        widest[max(blens)] = widest.get(max(blens), 0) + 1
    rounds = [len(b) for b in polya_blens.values()]
    log('poly(A) rounds: windows per bucket {}, reads by widest bucket {}, '
        '{} of {} reads took more than one round (at most {})'.format(
            json.dumps({str(k): v for k, v in sorted(windows.items())}),
            json.dumps({str(k): v for k, v in sorted(widest.items())}),
            sum(n > 1 for n in rounds), len(rounds), max(rounds)))
    log('poly(A) and unsplit stage timers:', json.dumps(
        {k: v for k, v in timings['stages'].items()
         if k.startswith(('C:polya', 'C:unsplit'))}))


def unsplit_summary(results, reads):
    """The unsplit filter's decisions against the reads made of two
    molecules: it must mark some of them and none of the others."""
    fused = {read_id for i, read_id in enumerate(reads) if two_molecules(i)}
    marked = {r['read_id'] for r in results if r['status'] == 'unsplit_read'}
    if any(r.get('label') != 'artifact' for r in results
           if r['read_id'] in marked):
        raise AssertionError('an unsplit read is not labelled artifact')
    log('unsplit filter: {} of {} two-molecule reads marked, {} of the '
        'other {} reads'.format(len(marked & fused), len(fused),
                                len(marked - fused), len(reads) - len(fused)))
    if not marked & fused or marked - fused:
        raise AssertionError('unsplit decisions do not follow the reads')


def training_step_parity():
    """One demux step at [64, 300] and one scaler step at [8, 2000], full
    widths, on the card and on the CPU from the same parameters, batch and
    noise: the loss within TRAIN_LOSS_RTOL relative, every gradient tensor
    within TRAIN_GRAD_RTOL of its largest CPU element."""
    from poreplex_torch.ops import rnn
    from poreplex_torch.training import data, train_demux, train_scaler
    rnn.use_full_fp32()
    rng = np.random.RandomState(SEED)
    gen = torch.Generator().manual_seed(SEED)
    batch = TRAIN_PARITY_BATCH['demux']
    windows, labels = data.demux_dataset(batch // 4, rng)
    windows = torch.as_tensor(windows[:batch])
    labels = torch.as_tensor(labels[:batch])
    noise = train_demux.NOISE_STDDEV * torch.randn(windows.shape,
                                                   generator=gen)
    cost = torch.as_tensor(train_demux.DEFAULT_COST_MAT)
    heads, targets = data.scaler_dataset(TRAIN_PARITY_BATCH['scaler'], rng)
    heads = torch.as_tensor(heads)
    targets = torch.as_tensor((targets - targets.mean(0)) / targets.std(0))
    cases = [
        ('demux', list(windows.shape), train_demux.DemuxNet,
         train_demux.init_params(gen),
         lambda net, dev: train_demux.loss(net, windows.to(dev),
                                           labels.to(dev), cost.to(dev),
                                           noise.to(dev))),
        ('scaler', list(heads.shape), train_scaler.ScalerNet,
         train_scaler.init_params(gen),
         lambda net, dev: train_scaler.loss(net, heads.to(dev),
                                            targets.to(dev))),
    ]
    for name, shape, net_class, params, loss in cases:
        out = {}
        for dev in (DEVICE, 'cpu'):
            net = net_class.from_params(params, dev)
            t0 = time.perf_counter()
            value = loss(net, dev)
            value.backward()
            if dev == DEVICE:
                torch.cuda.synchronize()
            out[dev] = (value.item(), time.perf_counter() - t0,
                        {n: p.grad.cpu() for n, p in net.named_parameters()})
        (got, card_s, got_grads), (want, cpu_s, grads) = out[DEVICE], \
            out['cpu']
        loss_err = abs(got - want) / abs(want)
        grad_err = max(float((got_grads[n] - g).abs().max() /
                             g.abs().max()) for n, g in grads.items())
        log('training step parity, {} {}: loss {:.8f} on the card, {:.8f} '
            'on the CPU (relative err {:.3e}); largest gradient err {:.3e} '
            'of its tensor\'s largest element over {} tensors; a cold step '
            '{:.2f} s on the card, {:.2f} s on the CPU'.format(
                name, shape, got, want, loss_err, grad_err, len(grads),
                card_s, cpu_s))
        if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL):
            raise AssertionError('{} training step on the card differs from '
                                 'the CPU'.format(name))


def timed_training(module, **kwargs):
    """module.train(**kwargs) on the card with its train_step timed (a
    host clock around the step, the card synchronised on both sides):
    (train's result, ms of each step)."""
    step = module.train_step
    times = []

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    module.train_step = timed_step
    try:
        result = module.train(log=log, device=DEVICE, **kwargs)
    finally:
        module.train_step = step
    return result, times


def train_on_card(outdir):
    """Both trainers through train() on the card at full widths, a few
    steps each; each step after the first timed, one more step profiled.
    Returns each network's checkpoint and its held-out inputs."""
    from poreplex_torch.training import data, layers, train_demux, \
        train_scaler
    demux_path = os.path.join(outdir, 'demux.npz')
    scaler_path = os.path.join(outdir, 'scaler.npz')
    acc, demux_ms = timed_training(
        train_demux, output_path=demux_path, steps=TRAIN_STEPS,
        batch_size=TRAIN_BATCH['demux'], n_per_class=TRAIN_SIZE['demux'],
        seed=SEED)
    stats, scaler_ms = timed_training(
        train_scaler, output_path=scaler_path, steps=TRAIN_STEPS,
        batch_size=TRAIN_BATCH['scaler'], n_samples=TRAIN_SIZE['scaler'],
        seed=SEED)

    # the held-out sets train() kept back, drawn again from the seed
    windows, labels = data.demux_dataset(TRAIN_SIZE['demux'],
                                         np.random.RandomState(SEED))
    eval_w = windows[:len(windows) // 4]
    heads, targets = data.scaler_dataset(TRAIN_SIZE['scaler'],
                                         np.random.RandomState(SEED))
    eval_h = heads[:len(heads) // 5]

    # one more step of each, profiled, from the trained parameters
    batch = TRAIN_BATCH['demux']
    net = train_demux.DemuxNet.from_params(np.load(demux_path), DEVICE)
    args = (torch.as_tensor(windows[-batch:], device=DEVICE),
            torch.as_tensor(labels[-batch:], device=DEVICE),
            train_demux.NOISE_STDDEV * torch.randn((batch, 300),
                                                   device=DEVICE),
            torch.as_tensor(train_demux.DEFAULT_COST_MAT, device=DEVICE))
    optimizer = layers.make_optimizer(net)
    demux_prof = profile('demux train step [{}, 300]'.format(batch),
                         lambda: train_demux.train_step(net, optimizer,
                                                        *args), host=False)
    batch = TRAIN_BATCH['scaler']
    net = train_scaler.ScalerNet.from_params(np.load(scaler_path), DEVICE)
    std = (targets[-batch:] - targets.mean(0)) / targets.std(0)
    args = (torch.as_tensor(heads[-batch:], device=DEVICE),
            torch.as_tensor(std, device=DEVICE))
    optimizer = layers.make_optimizer(net)
    scaler_prof = profile('scaler train step [{}, 2000]'.format(batch),
                          lambda: train_scaler.train_step(net, optimizer,
                                                          *args), host=False)
    for name, shape, ms, prof in (
            ('demux', [TRAIN_BATCH['demux'], 300], demux_ms, demux_prof),
            ('scaler', [TRAIN_BATCH['scaler'], 2000], scaler_ms,
             scaler_prof)):
        wall_ms, busy_ms, launches = prof
        log('training on the card, {} {}: {:.1f} ms a step (median of the '
            '{} steps after the first; all steps {}), {} kernel launches a '
            'step (profiler; {:.1f} ms wall under it, device busy {:.1f} ms, '
            '{:.1%})'.format(name, shape, float(np.median(ms[1:])),
                             len(ms) - 1, ', '.join('{:.1f}'.format(t)
                                                    for t in ms),
                             launches, wall_ms, busy_ms, busy_ms / wall_ms))
    log('demux held-out accuracy after {} steps {:.4f}; scaler {}'.format(
        TRAIN_STEPS, acc, json.dumps(stats)))
    log(card_line())
    return demux_path, eval_w, scaler_path, eval_h


def serve_trained(demux_path, eval_w, scaler_path, eval_h):
    """The trained checkpoints in DemuxModel and ScalerModel on the card:
    kernels 1 to 3 must launch, and the outputs hold within LSTM_ATOL of
    the training networks' forward (plain recurrences) on the held-out
    windows and heads, the scaler's in standardised units."""
    from poreplex_torch import kernels
    from poreplex_torch.models.demux import DemuxModel
    from poreplex_torch.models.scaler import ScalerModel
    from poreplex_torch.training import train_demux, train_scaler
    demux = DemuxModel(demux_path, device=DEVICE)
    scaler = ScalerModel(scaler_path, device=DEVICE)
    windows = torch.as_tensor(eval_w, device=DEVICE)
    heads = torch.as_tensor(eval_h, device=DEVICE)
    kernels.reset_launches()
    with torch.inference_mode():
        probs = demux(windows)
        scaling, _ = scaler(heads)
    torch.cuda.synchronize()
    launches = {name: kernels.launches[name] for name in
                ('lstm2_stacked', 'bidirectional_lstm', 'lstm_last')}
    if not all(launches.values()):
        raise AssertionError('trained models did not launch {}'.format(
            launches))
    with torch.no_grad():
        want_probs = train_demux.DemuxNet.from_params(
            np.load(demux_path), DEVICE)(windows)
        want_std = train_scaler.ScalerNet.from_params(
            np.load(scaler_path), DEVICE)(heads)
    xfrm = scaler.xfrm_t
    demux_err = float((probs - want_probs).abs().max())
    scaler_err = float(((scaling - xfrm[:, 1]) / xfrm[:, 0] -
                        want_std).abs().max())
    log('trained checkpoints through the serving kernels: launches {}; '
        'demux probabilities of {} held-out windows within {:.3e} of the '
        'training forward, scaler outputs of {} held-out heads within '
        '{:.3e} (standardised)'.format(json.dumps(launches), len(eval_w),
                                       demux_err, len(eval_h), scaler_err))
    if not (demux_err <= LSTM_ATOL and scaler_err <= LSTM_ATOL):
        raise AssertionError('trained models on the card differ from the '
                             'training forward')


def libhdf5_line():
    """Whether the dynamic loader opens libhdf5 here, by the sonames a
    native FAST5 reader tries; never fails."""
    import ctypes.util
    from poreplex_torch.fast5 import HDF5_SONAMES, find_libhdf5
    found = find_libhdf5()
    return 'libhdf5 probe: {} (tried {}; find_library("hdf5"): {})'.format(
        'dlopen of {} succeeded'.format(found) if found else
        'no soname opened', ', '.join(HDF5_SONAMES),
        ctypes.util.find_library('hdf5'))


# ----------------------------------------------------------------------
# data-parallel training: one NCCL rank a card (parallel/training.py)

# each trainer's configuration in a rank: step 0 is held against one
# card's step (and warms up), the next DP_TIMED are timed, and where the
# configuration is profiled, one more step runs under the profiler
DP_TIMED = 3
TRAINERS = ('train_demux', 'train_scaler')


def dp_configs(world):
    """(trainer, global batch, profiled) at ``world`` ranks: each network
    at its global batch of TRAIN_BATCH and, beyond one rank, at
    TRAIN_BATCH a card; launches do not depend on the batch, so only the
    batch a card is profiled."""
    configs = []
    for trainer, name in zip(TRAINERS, ('demux', 'scaler')):
        batch = TRAIN_BATCH[name]
        if world > 1:
            configs.append((trainer, batch, False))
        configs.append((trainer, batch * world, True))
    return configs


def gathered_max_diff(tensor):
    """The largest difference of any rank's ``tensor`` from rank 0's."""
    import torch.distributed as dist
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, tensor.contiguous())
    return max(float((p.double() - parts[0].double()).abs().max())
               for p in parts)


def dp_rank(replica, device, log, outdir):
    """One rank of the data-parallel phase: every configuration of
    dp_configs through the trainer's own fit() with its train_step
    wrapped, which times and profiles the steps and, after step 0 and the
    last step, compares every rank's global inputs and parameters with
    rank 0's. Rank 0 returns every rank's records, its first step's
    inputs, parameters, loss and gradients, and its checkpoints."""
    import importlib
    import torch.distributed as dist
    records = []
    for trainer, batch, profiled in dp_configs(replica.world):
        module = importlib.import_module('poreplex_torch.training.' + trainer)
        step = module.train_step
        record = {'trainer': trainer, 'batch': batch, 'ms': [], 'steps': 0}
        steps = 1 + DP_TIMED + profiled

        def wrapped(net, optimizer, *args):
            k = record['steps']
            record['steps'] += 1
            inputs = args[:-1]
            if k == 0:
                record['global'] = len(inputs[0])
                record['inputs_diff'] = max(gathered_max_diff(t)
                                            for t in inputs)
                params = {n: p.detach().cpu().numpy().copy()
                          for n, p in net.named_parameters()}
                value = step(net, optimizer, *args)
                record['loss'] = float(value)
                if replica.rank == 0:
                    record['first'] = {
                        'params': params,
                        'inputs': [t.cpu().numpy() for t in inputs],
                        'grads': {n: p.grad.cpu().numpy()
                                  for n, p in net.named_parameters()}}
            elif k <= DP_TIMED:
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                value = step(net, optimizer, *args)
                torch.cuda.synchronize()
                dist.barrier()
                record['ms'].append((time.perf_counter() - t0) * 1e3)
            else:
                out = []
                wall_ms, spans = traced(
                    lambda: out.append(step(net, optimizer, *args)), False)
                value = out[0]
                record['trace'] = {
                    'wall_ms': wall_ms, 'busy_ms': busy_ms(spans),
                    # an NCCL kernel spins until the last rank joins it
                    'compute_ms': busy_ms([sp for sp in spans
                                           if 'nccl' not in sp[2].lower()]),
                    'launches': kernel_launches(spans),
                    'nccl_ms': sum(stop - start for start, stop, name in spans
                                   if 'nccl' in name.lower()) / 1e3,
                    'nccl_launches': sum('nccl' in name.lower()
                                         for _, _, name in spans)}
            if k == steps - 1:
                record['params_diff'] = gathered_max_diff(torch.cat(
                    [p.detach().reshape(-1) for p in net.parameters()]))
            return value

        path = os.path.join(outdir, '{}-{}-{}.npz'.format(
            trainer, replica.world, batch))
        size = dict(n_per_class=TRAIN_SIZE['demux']) \
            if trainer == 'train_demux' else \
            dict(n_samples=TRAIN_SIZE['scaler'])
        module.train_step = wrapped
        record['result'] = module.fit(
            replica, device, log, output_path=path, steps=steps,
            batch_size=batch, seed=SEED, learning_rate=1e-3,
            eval_fraction=0.25 if trainer == 'train_demux' else 0.2,
            data=None, **size)
        module.train_step = step
        record['path'] = path
        records.append(record)
    ranks = [None] * replica.world
    dist.all_gather_object(ranks, [{k: v for k, v in r.items()
                                    if k != 'first'} for r in records])
    return {'ranks': ranks, 'first': [r.get('first') for r in records]}


def first_step_on_one_card(trainer, first):
    """The trainer's one-process step on cuda:0 from rank 0's parameters
    and global inputs: (loss, gradients by parameter name)."""
    import importlib
    from poreplex_torch.ops import rnn
    from poreplex_torch.training import layers
    rnn.use_full_fp32()
    module = importlib.import_module('poreplex_torch.training.' + trainer)
    net_class = module.DemuxNet if trainer == 'train_demux' else \
        module.ScalerNet
    net = net_class.from_params({n.replace('.', '/'): v for n, v in
                                 first['params'].items()}, DEVICE)
    value = module.train_step(net, layers.make_optimizer(net), *[
        torch.as_tensor(a, device=DEVICE) for a in first['inputs']])
    return float(value), {n: p.grad.cpu().numpy()
                          for n, p in net.named_parameters()}


def check_data_parallel(card, worlds):
    """Both trainers' fit() on ranks of one card each (NCCL) at every world
    size of ``worlds``, through parallel.training.launch as the trainers'
    --data-parallel runs them: each configuration's first step against
    one card's on the same global batch from the same parameters (the
    loss within TRAIN_LOSS_RTOL relative, every gradient within
    TRAIN_GRAD_RTOL of its tensor's largest element); every rank's global
    inputs (batch, labels, noise) after step 0 and its parameters after
    the last step equal to rank 0's; ms a step (median of DP_TIMED, every
    rank synchronised before and after), launches, NCCL device time and
    device busy share of a profiled step, by rank. Returns the
    checkpoints of the last world's profiled configurations by
    trainer."""
    import hashlib
    from poreplex_torch.parallel import training
    checkpoints, references = {}, {}
    with tempfile.TemporaryDirectory() as outdir:
        for world in worlds:
            devices = [torch.device('cuda', k) for k in range(world)]
            t0 = time.perf_counter()
            out = training.launch(dp_rank, devices, {'outdir': outdir},
                                  log=lambda line: None)
            wall_s = time.perf_counter() - t0
            for k, first in enumerate(out['first']):
                ranks = [r[k] for r in out['ranks']]
                trainer, batch = ranks[0]['trainer'], ranks[0]['global']
                # rank 0's parameters and a global batch recur across D
                key = hashlib.sha256(b''.join(
                    [a.tobytes() for _, a in sorted(first['params'].items())]
                    + [a.tobytes() for a in first['inputs']])).hexdigest()
                if key not in references:
                    references[key] = first_step_on_one_card(trainer, first)
                want, grads = references[key]
                loss_err = abs(ranks[0]['loss'] - want) / abs(want)
                grad_err = max(float(np.abs(first['grads'][n] - g).max() /
                                     np.abs(g).max())
                               for n, g in grads.items())
                traces = [r.get('trace') for r in ranks]
                log('data-parallel training, {} at D = {} (NCCL), global '
                    'batch {} ({} a rank): {:.1f} ms a step (median of {}; '
                    'by rank {}); first step against one card: loss {:.8f} '
                    'against {:.8f} (relative err {:.3e}), largest gradient '
                    'err {:.3e} of its tensor\'s largest element; every '
                    'rank\'s global inputs within {:.3e} of rank 0\'s after '
                    'step 0, its parameters within {:.3e} after the last '
                    'step{}; {}'.format(
                        trainer, world, batch, batch // world,
                        float(np.median(ranks[0]['ms'])), DP_TIMED,
                        [['{:.1f}'.format(t) for t in r['ms']]
                         for r in ranks],
                        ranks[0]['loss'], want, loss_err, grad_err,
                        max(r['inputs_diff'] for r in ranks),
                        max(r['params_diff'] for r in ranks),
                        '' if traces[0] is None else
                        '; a profiled step by rank: launches {}, NCCL '
                        'kernels {} taking {} ms (their waits for the '
                        'other ranks included), device busy {} of {} ms '
                        'wall ({}; without the NCCL kernels {} ms, '
                        '{})'.format(
                            [t['launches'] for t in traces],
                            [t['nccl_launches'] for t in traces],
                            ['{:.4f}'.format(t['nccl_ms']) for t in traces],
                            ['{:.1f}'.format(t['busy_ms']) for t in traces],
                            ['{:.1f}'.format(t['wall_ms']) for t in traces],
                            ['{:.1%}'.format(t['busy_ms'] / t['wall_ms'])
                             for t in traces],
                            ['{:.1f}'.format(t['compute_ms'])
                             for t in traces],
                            ['{:.1%}'.format(t['compute_ms'] / t['wall_ms'])
                             for t in traces]),
                        card))
                if not (loss_err <= TRAIN_LOSS_RTOL and
                        grad_err <= TRAIN_GRAD_RTOL):
                    raise AssertionError('{} at D = {}: the first step '
                                         'differs from one card\'s'.format(
                                             trainer, world))
                if any(r['inputs_diff'] or r['params_diff'] for r in ranks):
                    raise AssertionError('{} at D = {}: a rank\'s inputs or '
                                         'parameters differ from rank '
                                         '0\'s'.format(trainer, world))
                if world > 1 and traces[0] is not None and not all(
                        t['nccl_launches'] for t in traces):
                    raise AssertionError('{} at D = {}: no NCCL kernel in a '
                                         'step'.format(trainer, world))
                checkpoints[trainer] = ranks[0]['path']
            log('data-parallel training at D = {}: {:.1f} s with the ranks\' '
                'start-up'.format(world, wall_s))
        evaluate_workflows(checkpoints)


def evaluate_workflows(checkpoints):
    """The workflows' evaluate on the data-parallel checkpoints on the
    card, over the held-out windows and heads train() kept back (drawn
    again from the seed): kernels 1 to 3 must launch."""
    from poreplex_torch import kernels
    from poreplex_torch.training import data, scaler_workflow, workflow
    windows, labels = data.demux_dataset(TRAIN_SIZE['demux'],
                                         np.random.RandomState(SEED))
    heads, targets = data.scaler_dataset(TRAIN_SIZE['scaler'],
                                         np.random.RandomState(SEED))
    n_eval = int(len(heads) * 0.2)
    with tempfile.TemporaryDirectory() as outdir:
        kernels.reset_launches()
        acc = workflow.evaluate(checkpoints['train_demux'], (windows, labels),
                                os.path.join(outdir, 'demux.txt'), log=log,
                                device=DEVICE)
        lines = scaler_workflow.evaluate(
            checkpoints['train_scaler'], heads[:n_eval], targets[:n_eval],
            os.path.join(outdir, 'scaler.txt'), log=log, device=DEVICE)
        torch.cuda.synchronize()
    launches = {name: kernels.launches[name] for name in
                ('lstm2_stacked', 'bidirectional_lstm', 'lstm_last')}
    log('the workflows\' evaluate on the data-parallel checkpoints: demux '
        'accuracy {:.4f}, scaler {}; launches {}'.format(
            acc, '; '.join(lines), json.dumps(launches)))
    if not all(launches.values()):
        raise AssertionError('the workflows\' evaluate did not launch '
                             '{}'.format(launches))


# ----------------------------------------------------------------------
# several cards: the kernels on every card, the mesh of one process, ranks

# wrapper -> its kernel function, as the profiler names it
KERNEL_FUNCTIONS = {
    'lstm2_stacked': 'lstm2_stacked_kernel',
    'bidirectional_lstm': 'bilstm_kernel',
    'lstm_last': 'lstm_last_kernel',
    'viterbi_extents': 'viterbi_extents_kernel',
    'viterbi': 'viterbi_path_kernel',
    'detect_peaks': 'peaks_kernel',
    'polya_dp': 'dp_kernel',
}
# the stage timers each mesh line gives
MESH_STAGES = ('B:device_stage1', 'C:polya', 'C:polya/launch',
               'C:polya/collect', 'C:unsplit_viterbi')
# reads of the ranks' phase (and of the mesh under --multi-card), from a
# generator of their own: every rank makes them from the seed
RANK_READS = N_READS
RANK_SEED = SEED + 4
# a rank's bound on its whole run, start-up and simulation included
RANK_TIMEOUT = 600


def synchronize_all():
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


@torch.inference_mode()
def check_every_card(config):
    """Each of the seven wrappers on tensors on cuda:k, for every visible
    card k, with cuda:0 current, at small shapes against its plain version
    on the same inputs: the LSTMs within LSTM_ATOL, the Viterbi extents
    and paths, the peak emissions and the DP intervals exactly, the
    Viterbi logp within LOGP_RTOL relative. The launch must leave cuda:0
    current."""
    from poreplex_torch.kernels import (event_detection as ked,
                                        lstm as klstm, polya_dp as kdp,
                                        viterbi as kvit)
    from poreplex_torch.ops import (event_detection as ed, polya_dp as dp_ops,
                                    rnn, viterbi as vit_ops)
    from poreplex_torch.pipeline.engine import DeviceEngine
    p = config['polya_dwell']['event_detection']
    peak_args = (float(p['threshold1']), float(p['threshold2']),
                 p['window_length1'], p['window_length2'],
                 float(p['peak_height']))
    torch.cuda.set_device(0)
    for k in range(torch.cuda.device_count()):
        dev = torch.device('cuda', k)
        rng = np.random.default_rng(SEED + 10 + k)
        engine = DeviceEngine(config, device=dev)
        scaler, demux = engine.scaler, engine.demux

        def on(a):
            return torch.as_tensor(a, device=dev)
        heads = on(rng.normal(90, 12, (8, 200, 1)).astype(np.float32))
        windows = on(rng.normal(0, 1, (8, 100, 1)).astype(np.float32))
        seq = rnn.bidirectional_lstm(demux.bilstm_fwd, demux.bilstm_bwd,
                                     windows)
        xs, lens = viterbi_inputs(rng, 1200)
        x, lengths = on(xs[:8]), on(lens[:8])
        ev_x = on((rng.choice([71.5, 102.1, 112.0, 80.5, 108.95], (8, 38))
                   .repeat(8, axis=1) + rng.normal(0, 3.0, (8, 304)))
                  .astype(np.float32))
        ev_len = on(rng.integers(150, 305, 8).astype(np.int32))
        pw, plen = polya_windows(rng, 8, 2048)
        pw, plen = on(pw), on(plen)
        _, cs, css = ed._centered_cumsums(pw, plen)
        t1 = ed.compute_tstat(cs, css, plen, p['window_length1'])
        t2 = ed.compute_tstat(cs, css, plen, p['window_length2'])
        mask_a = on(rng.uniform(size=(8, 64)) < 0.6)
        mask_b = on(rng.uniform(size=(8, 64)) < 0.6)
        dp_len = on(rng.integers(1, 300, (8, 64)).astype(np.float32))
        dp_n = on(rng.integers(8, 65, 8).astype(np.int32))
        # name: (kernel call, plain call, how held)
        cases = {
            'lstm2_stacked': (
                lambda: klstm.lstm2_stacked(scaler.lstm1, scaler.lstm2,
                                            heads),
                lambda: rnn.lstm2_stacked(scaler.lstm1, scaler.lstm2, heads),
                'atol'),
            'bidirectional_lstm': (
                lambda: klstm.bidirectional_lstm(demux.bilstm_fwd,
                                                 demux.bilstm_bwd, windows),
                lambda: seq, 'atol'),
            'lstm_last': (
                lambda: klstm.lstm_last(demux.lstm2, seq),
                lambda: rnn.lstm(demux.lstm2, seq, return_sequences=False),
                'atol'),
            'viterbi_extents': (
                lambda: kvit.viterbi_extents(x, lengths,
                                             *engine.segmodel.params()),
                lambda: vit_ops.viterbi_extents(x, lengths,
                                                *engine.segmodel.params()),
                'logp'),
            'viterbi': (
                lambda: kvit.viterbi(ev_x, ev_len,
                                     *engine.unsplitmodel.params()),
                lambda: vit_ops.viterbi(ev_x, ev_len,
                                        *engine.unsplitmodel.params()),
                'logp'),
            # the plain detector on CPU copies (its loop of small launches
            # is slow on a card)
            'detect_peaks': (
                lambda: ked.detect_peaks(t1, t2, plen, *peak_args),
                lambda: ed.detect_peaks(t1.cpu(), t2.cpu(), plen.cpu(),
                                        *peak_args), 'exact'),
            'polya_dp': (
                lambda: kdp.dp(mask_a, mask_b, dp_len, dp_n, 1.5, 110),
                lambda: dp_ops.dp_core(
                    torch.cat([mask_a, mask_b]), torch.cat([dp_len] * 2),
                    torch.cat([dp_n] * 2), 1.5, 110), 'exact'),
        }
        held = []
        for name, (kernel, plain, how) in cases.items():
            got = kernel()
            if torch.cuda.current_device() != 0:
                raise AssertionError('{} on {} left cuda:{} current'.format(
                    name, dev, torch.cuda.current_device()))
            ref = plain()
            got = [got] if how == 'atol' else list(got)
            ref = [ref] if how == 'atol' else list(ref)
            if any(g.device != dev for g in got):
                raise AssertionError('{}: output not on {}'.format(name, dev))
            got, ref = [g.cpu() for g in got], [r.cpu() for r in ref]
            if how == 'atol':
                err = float((got[0] - ref[0]).abs().max())
                ok = np.isfinite(err) and err <= LSTM_ATOL
            else:
                exact = got[:-1] if how == 'logp' else got
                err = sum(int((a != b).sum()) for a, b in
                          zip(exact, ref[:len(exact)]))
                ok = err == 0
                if how == 'logp':
                    rel = float(((got[-1] - ref[-1]).abs() /
                                 ref[-1].abs().clamp(min=1.0)).max())
                    ok = ok and rel <= LOGP_RTOL
            if not ok:
                raise AssertionError('{} on {} with cuda:0 current: {} vs '
                                     'the plain version'.format(name, dev,
                                                                err))
            held.append(name)
        synchronize_all()
        log('kernels on {} ({}) with cuda:0 current: {} == plain version'
            .format(dev, torch.cuda.get_device_name(dev), ', '.join(held)))
        del engine


def launches_by_card(fn):
    """fn() under the profiler (device trace): ({wrapper: {card index:
    kernel launches}} from the device ids of its kernel events, {card
    index: device busy ms}, the wall ms). Busy is the union of a card's
    kernel and copy intervals, as profile() counts it."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    synchronize_all()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize_all()
        wall_ms = (time.perf_counter() - t0) * 1e3
    patterns = {name: re.compile(r'\b{}\b'.format(kernel))
                for name, kernel in KERNEL_FUNCTIONS.items()}
    counts = {name: {} for name in KERNEL_FUNCTIONS}
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation() or
                e.name().startswith('Activity Buffer')):
            continue
        spans.setdefault(e.device_index(), []).append(
            (e.start_ns() / 1e6, e.end_ns() / 1e6))
        for name, pattern in patterns.items():
            if pattern.search(e.name()):
                card = counts[name]
                card[e.device_index()] = card.get(e.device_index(), 0) + 1
    busy = {}
    for card, intervals in sorted(spans.items()):
        total, end = 0.0, float('-inf')
        for start, stop in sorted(intervals):
            total += max(0.0, stop - max(start, end))
            end = max(end, stop)
        busy[card] = total
    return counts, busy, wall_ms


def mesh_records(analyzer, reads):
    from poreplex_torch import simulate
    from poreplex_torch.pipeline.read import ReadRecord
    stopped, records = [], []
    for read in reads:
        rec = ReadRecord('simulated.fast5', analyzer.inputdir, read.read_id)
        analyzer.add_read(rec, simulate.MemoryRead(read), stopped, records)
    return stopped, records


def run_mesh(config, reads, devices):
    """The reads through one BatchAnalyzer on ``devices``, after an untimed
    pass over the same reads (PyTorch's kernels loaded on every card, at
    the timed pass's shapes). The launch counts are reset just before the
    timed pass and read just after. Returns (results, stage-1 outputs,
    wall seconds of process_batch, launches, launches by card: of a
    profiled pass over several devices, else the launches; that pass's
    ({card: device busy ms}, wall ms), or None; the timed pass's stage
    timers)."""
    from poreplex_torch import kernels
    from poreplex_torch.pipeline.analyzer import BatchAnalyzer
    from poreplex_torch.utils import GLOBAL_TIMER
    analyzer = BatchAnalyzer(config, devices=devices)
    analyzer.process_batch(None, mesh_records(analyzer, reads))
    preloaded = mesh_records(analyzer, reads)
    stage1 = {}
    run_stage1 = analyzer.run_stage1

    def keep_stage1(recs):
        stage1.update(run_stage1(recs))
        return stage1
    analyzer.run_stage1 = keep_stage1
    synchronize_all()
    GLOBAL_TIMER.totals.clear()
    GLOBAL_TIMER.counts.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    results, _ = analyzer.process_batch(None, preloaded)
    synchronize_all()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    stages = GLOBAL_TIMER.snapshot()
    del analyzer.run_stage1
    if len(devices) == 1:
        by_card = {name: {devices[0].index: n}
                   for name, n in launches.items()}
        busy = None
    else:
        by_card, busy_ms, profiled_ms = launches_by_card(
            lambda: analyzer.process_batch(None,
                                           mesh_records(analyzer, reads)))
        busy = (busy_ms, profiled_ms)
    return results, stage1, wall_s, launches, by_card, busy, stages


def same_result(a, b, where):
    """Equal report values, floats within LSTM_ATOL; returns a mismatch's
    path, or None."""
    if isinstance(a, float) or isinstance(b, float):
        return None if abs(a - b) <= LSTM_ATOL else where
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return where
        for k in a:
            bad = same_result(a[k], b[k], '{}.{}'.format(where, k))
            if bad:
                return bad
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return where
        for i, (x, y) in enumerate(zip(a, b)):
            bad = same_result(x, y, '{}[{}]'.format(where, i))
            if bad:
                return bad
        return None
    return None if a == b else where


def check_mesh(config, reads, card):
    """The reads through a BatchAnalyzer on one card, then on meshes of 2
    and 4 cards where that many are visible, and on a mesh of every
    visible card, or [cuda:0, cuda:0] on one card (the sharded code on
    one card), then on one card again (the runs are timed in turns):
    every report equal to the first run's (floats within LSTM_ATOL:
    extents, QC, demux labels, poly(A) begin, end and dwell and unsplit
    decisions exact), stage 1's decisions exact and its scaling and demux
    probabilities within LSTM_ATOL, every kernel launched on every card
    of the mesh. Prints reads/s of each and the launches of each kernel
    by card."""
    count = torch.cuda.device_count()
    cuda = [torch.device('cuda', k) for k in range(count)]
    meshes = [cuda[:1]] + [cuda[:d] for d in (2, 4) if d < count] + \
        [cuda if count > 1 else cuda[:1] * 2] + [cuda[:1]]
    runs = []
    for devices in meshes:
        results, stage1, wall_s, launches, by_card, busy, stages = run_mesh(
            config, reads, devices)
        names = ', '.join(str(d) for d in devices)
        missing = [k for k, v in launches.items() if v == 0]
        unused = sorted({(name, d.index) for name in KERNEL_FUNCTIONS
                         for d in devices
                         if not by_card[name].get(d.index)})
        if missing or unused:
            raise AssertionError('mesh [{}]: never launched {}; no launch '
                                 'of (kernel, card) {}'.format(
                                     names, missing, unused))
        log('mesh [{}]: {} reads, {:.1f} reads/s ({:.3f} s of '
            'process_batch); launches {}; launches by card{} {}; stage '
            'timers (s) {}{}; {}'.format(
                names, len(reads), len(reads) / wall_s, wall_s,
                json.dumps(launches),
                ' (profiler device ids)' if len(devices) > 1 else '',
                json.dumps(by_card), json.dumps({
                    k: round(stages[k]['total_s'], 4) for k in MESH_STAGES
                    if k in stages}),
                '' if busy is None else '; a profiled pass: wall {:.1f} ms, '
                'device busy by card {}'.format(busy[1], ', '.join(
                    '{} {:.2f} ms ({:.1%})'.format(k, ms, ms / busy[1])
                    for k, ms in busy[0].items())),
                card))
        runs.append((devices, results, stage1))
    _, ref, ref_stage1 = runs[0]
    for devices, results, stage1 in runs[1:]:
        names = ', '.join(str(d) for d in devices)
        if [r['read_id'] for r in results] != [r['read_id'] for r in ref]:
            raise AssertionError('mesh [{}]: reads out of order'.format(
                names))
        for a, b in zip(results, ref):
            bad = same_result(a, b, a['read_id'])
            if bad:
                raise AssertionError('mesh [{}]: {} differs from one '
                                     'card'.format(names, bad))
        for key in ('first', 'last', 'present', 'qc_ok', 'demux_ok'):
            if not np.array_equal(stage1[key], ref_stage1[key]):
                raise AssertionError('mesh [{}]: stage-1 {} differs'.format(
                    names, key))
        for key in ('scaling', 'demux_probs'):
            err = float(np.abs(stage1[key] - ref_stage1[key]).max())
            if not err <= LSTM_ATOL:
                raise AssertionError('mesh [{}]: stage-1 {} err {}'.format(
                    names, key, err))
        log('mesh [{}] == the first one-card run for {} reads ({} tails, '
            '{} unsplit; reports equal, stage-1 decisions exact, scaling and '
            'demux probabilities within {})'.format(
                names, len(results), sum('polya' in r for r in results),
                sum(r['status'] == 'unsplit_read' for r in results),
                LSTM_ATOL))


def rank_argv(indir, outdir):
    return ['-i', indir, '-o', outdir, '-y', '-q', '--barcoding',
            '--barcoding-quality-filter', str(BARCODE_PHRED), '--polya',
            '--filter-chimera', '--trim-adapter', '--batch-size', str(BATCH),
            '--device-batch-size', str(BATCH), '--mesh-shape', '1']


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def wait_for(paths, what, timeout=RANK_TIMEOUT):
    t0 = time.time()
    while not all(os.path.exists(p) for p in paths):
        if time.time() - t0 > timeout:
            raise AssertionError('timed out waiting for ' + what)
        time.sleep(0.01)


def rank_main(argv):
    """One rank of the ranks' phase, started by check_ranks:
    ``--rank R RANKS PORT WORKDIR``. Makes the reads from the seed, warms
    its card up once the one process's run is over, waits for the others
    and the start signal, then runs commandline.main over its share and
    writes rank-R.json."""
    from poreplex_torch import commandline, kernels
    from poreplex_torch.config import build_config
    from poreplex_torch.pipeline.analyzer import BatchAnalyzer
    from poreplex_torch.pipeline.source import MemorySource
    rank, ranks, port, work = int(argv[0]), int(argv[1]), argv[2], argv[3]
    reads = make_reads(np.random.default_rng(RANK_SEED), RANK_READS)
    indir = os.path.join(work, 'in')
    outdir = os.path.join(work, 'rank-{}'.format(rank))
    wait_for([os.path.join(work, 'warm')], 'the warm-up signal')
    with tempfile.TemporaryDirectory() as tmp:
        warm = BatchAnalyzer(build_config(
            tmp, tmp, barcoding=True, trim_adapter=True, mesh_shape=1,
            measure_polya=True, filter_unsplit_reads=True))
        warm.process_batch(None, mesh_records(warm, reads[:16]))
        del warm
    torch.cuda.synchronize()
    with open(os.path.join(work, 'ready-{}'.format(rank)), 'w'):
        pass
    wait_for([os.path.join(work, 'go')], 'the start signal')
    args = commandline.parse_args(rank_argv(indir, outdir) + [
        '--num-nodes', str(ranks), '--node-rank', str(rank),
        '--coordinator', '127.0.0.1:{}'.format(port)])
    kernels.reset_launches()
    start = time.time()
    printer = commandline.main(args, source=MemorySource(reads))
    torch.cuda.synchronize()
    end = time.time()
    header, rows = summary_rows(outdir)
    with open(os.path.join(outdir, '.processed-reads')) as f:
        manifest = sorted(line.split('\t')[1] for line in f.read().split(
            '\n') if line)
    out = {'rank': rank, 'start': start, 'end': end,
           'launches': dict(kernels.launches), 'header': header,
           'rows': rows, 'manifest': manifest,
           'counts': None if printer is None else sorted(
               [list(map(str, key)), value]
               for key, value in printer.__self__.counts.items()),
           'card': torch.cuda.get_device_name(0),
           'visible': os.environ.get('CUDA_VISIBLE_DEVICES')}
    with open(os.path.join(work, 'rank-{}.json'.format(rank)), 'w') as f:
        json.dump(out, f)
    return 0


def check_ranks(card, reads=None):
    """Ranks, each a process of this script (rank_main) with one card
    through CUDA_VISIBLE_DEVICES: one a card up to four when two or more
    are visible, else two sharing cuda:0. Each makes the RANK_READS reads
    from RANK_SEED and runs commandline.main with --num-nodes, --node-rank
    and --coordinator over them. Meanwhile this process runs the same
    reads through the command line alone. The ranks' manifests are
    disjoint, their summary rows together are the one process's, rank 0's
    merged counts are its counts, and every rank launches every kernel.
    Prints reads/s from the first rank's start to the last rank's end
    (ranks start together, after simulating their reads and warming their
    cards up, which they do once the one process's run is over). ``reads``:
    the RANK_READS reads of RANK_SEED where the caller has them."""
    from poreplex_torch.pipeline.source import MemorySource
    count = torch.cuda.device_count()
    ranks = min(4, count) if count > 1 else 2
    visible = os.environ.get('CUDA_VISIBLE_DEVICES')
    cards = (visible.split(',') if visible else
             [str(k) for k in range(count)])
    cards = cards[:ranks] if count > 1 else cards[:1] * ranks
    port = free_port()
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, 'in'))
        procs = []
        try:
            for rank in range(ranks):
                logf = open(os.path.join(work, 'log-{}'.format(rank)), 'w')
                procs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), '--rank',
                     str(rank), str(ranks), str(port), work],
                    stdout=logf, stderr=subprocess.STDOUT,
                    env=dict(os.environ, CUDA_VISIBLE_DEVICES=cards[rank])),
                    logf))
            # the one process, while the ranks simulate and warm up
            if reads is None:
                reads = make_reads(np.random.default_rng(RANK_SEED),
                                   RANK_READS)
            outdir = os.path.join(work, 'one')
            result, wall_s, launches, _ = run_cli(
                rank_argv(os.path.join(work, 'in'), outdir),
                MemorySource(reads))
            if result is None:
                raise AssertionError('the one-process CLI run did not finish')
            header, rows = summary_rows(outdir)
            counts = sorted([list(map(str, key)), value]
                            for key, value in result.__self__.counts.items())
            with open(os.path.join(outdir, '.processed-reads')) as f:
                manifest = sorted(line.split('\t')[1] for line in
                                  f.read().split('\n') if line)
            log('ranks: one process over the {} reads: {:.1f} reads/s '
                '({:.3f} s); {}'.format(len(reads), len(reads) / wall_s,
                                        wall_s, card))
            with open(os.path.join(work, 'warm'), 'w'):
                pass
            wait_for([os.path.join(work, 'ready-{}'.format(r))
                      for r in range(ranks)], 'the ranks to warm up')
            with open(os.path.join(work, 'go'), 'w'):
                pass
            for proc, logf in procs:
                code = proc.wait(timeout=RANK_TIMEOUT)
                if code != 0:
                    raise AssertionError('a rank exited with {}'.format(code))
        except BaseException:
            for proc, logf in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for rank in range(len(procs)):
                with open(os.path.join(work, 'log-{}'.format(rank))) as f:
                    log('rank {} log:\n{}'.format(rank, f.read()[-3000:]))
            raise
        finally:
            for _, logf in procs:
                logf.close()
        outs = []
        for rank in range(ranks):
            with open(os.path.join(work, 'rank-{}.json'.format(rank))) as f:
                outs.append(json.load(f))
    owned = [set(o['manifest']) for o in outs]
    if sum(len(m) for m in owned) != len(set().union(*owned)):
        raise AssertionError('the ranks\' manifests overlap')
    if set().union(*owned) != set(manifest) or not all(owned):
        raise AssertionError('the ranks\' manifests are not the one '
                             'process\'s')
    merged_rows = {}
    for o in outs:
        merged_rows.update(o['rows'])
        if o['header'] != header:
            raise AssertionError('rank {}: another summary header'.format(
                o['rank']))
    if merged_rows != rows:
        differ = sorted(k for k in set(rows) | set(merged_rows)
                        if rows.get(k) != merged_rows.get(k))
        raise AssertionError('the ranks\' summary rows differ from the one '
                             'process\'s, e.g. {}'.format(differ[:3]))
    if outs[0]['counts'] != counts or any(o['counts'] is not None
                                          for o in outs[1:]):
        raise AssertionError('rank 0\'s merged counts {} are not the one '
                             'process\'s {}'.format(outs[0]['counts'],
                                                    counts))
    for o in outs:
        missing = [k for k, v in o['launches'].items() if v == 0]
        if missing:
            raise AssertionError('rank {} never launched {}'.format(
                o['rank'], missing))
    span = max(o['end'] for o in outs) - min(o['start'] for o in outs)
    log('ranks: {} ranks on CUDA_VISIBLE_DEVICES {}: {} reads in {:.3f} s '
        'from the first rank\'s start to the last rank\'s end, {:.1f} '
        'reads/s; rank runs {}; reads a rank {}; launches by rank {}; '
        'manifests disjoint, summary rows and rank 0\'s merged counts equal '
        'to the one process\'s; {}'.format(
            ranks, [o['visible'] for o in outs], len(rows), span,
            len(rows) / span,
            ['{:.3f} s'.format(o['end'] - o['start']) for o in outs],
            [len(o['rows']) for o in outs],
            json.dumps([o['launches'] for o in outs]), card))


def main(argv):
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if argv[:1] == ['--rank']:
        return rank_main(argv[1:])
    multi_card = argv == ['--multi-card']
    if argv and not multi_card:
        print('usage: chip_smoke.py [--multi-card]', file=sys.stderr)
        return 2
    from poreplex_torch import simulate
    from poreplex_torch.config import build_config
    from poreplex_torch.kernels import _build
    from poreplex_torch.pipeline.engine import DeviceEngine

    t0 = time.perf_counter()
    fast_div_build = None if multi_card else start_fast_div_build()
    reports = _build.build_all()
    log('built {} in {:.1f} s ({})'.format(
        ', '.join(reports), time.perf_counter() - t0, ', '.join(
            '{} {:.1f} s'.format(source, seconds)
            for source, seconds in _build.build_seconds.items())))
    fast_div = fast_div_build and fast_div_library(fast_div_build)
    if fast_div:
        log('built {} beside them, {:.1f} s from the start'.format(
            FAST_DIV_SOURCE, time.perf_counter() - t0))
    for source, report in reports.items():
        for line in _build.usage_lines(source, report):
            log('  ' + line)
    card = card_line()
    log(card)
    log('torch {} cuda {} on {}'.format(torch.__version__, torch.version.cuda,
                                        torch.cuda.get_device_name(0)))

    with tempfile.TemporaryDirectory() as outdir:
        # the phases of one card run on cuda:0 whatever the card count
        config = build_config(outdir, outdir, barcoding=True,
                              trim_adapter=True, device='cuda',
                              device_batch_size=BATCH,
                              barcoding_quality_filter=BARCODE_PHRED,
                              measure_polya=True, filter_unsplit_reads=True,
                              mesh_shape=1)
        if multi_card:
            check_every_card(config)
            reads = make_reads(np.random.default_rng(RANK_SEED), RANK_READS)
            check_mesh(config, reads, card)
            check_ranks(card, reads)
            check_data_parallel(card, [world for world in (1, 2, 4)
                                       if world <= torch.cuda.device_count()])
            log('chip_smoke --multi-card took {:.1f} s'.format(
                time.perf_counter() - t0))
            print(card)
            print(json.dumps({'ok': True, 'device': {
                'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                'count': torch.cuda.device_count()}}))
            return 0
        rng = np.random.default_rng(SEED)

        engine = DeviceEngine(config)
        with torch.inference_mode():
            rows = (check_lstms(engine, rng) + check_viterbi(engine, rng) +
                    check_peaks(rng, config['polya_dwell'],
                                ((BATCH, 8192), (8, 16384))) +
                    check_dp(rng) +
                    check_unsplit_viterbi(engine.unsplitmodel, rng,
                                          ((1024, 1024), (1024, 128))))
        del engine
        for row in rows:
            log(kernel_line(row))
        check_polya_graphs(config['polya_dwell'])
        check_fast_div(fast_div, np.random.default_rng(FAST_DIV_SEED))

        (results, timings, launches, analyzer, stage1_inputs, reads,
         stage1_run, polya_blens) = run_main_path(config, rng)
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
        polya_summary(results, timings, reads, polya_blens)
        unsplit_summary(results, reads)
        check_against_cpu(config, analyzer, stage1_inputs[:8])
        check_polya_unsplit_against_cpu(config, results, reads, stage1_run,
                                        polya_blens)
        # the 32,768 bucket's launch, and a batch that is not whole blocks
        # with a length that is not a multiple of 4 (the kernel's 4-byte
        # copies), held against the plain version on the CPU after the
        # main path (whose host work it would otherwise precede), from a
        # generator of their own; so are a larger unsplit bucket and the
        # Viterbi tie case
        with torch.inference_mode():
            wide = check_peaks(np.random.default_rng(SEED + 1),
                               config['polya_dwell'],
                               ((64, 32768), (37, 2002)), 'cpu')
            rng2 = np.random.default_rng(SEED + 2)
            wide += (check_unsplit_viterbi(analyzer.engine.unsplitmodel, rng2,
                                           ((64, 4096),)) +
                     check_viterbi_ties(rng2))
        for row in wide:
            log(kernel_line(row))
        rows += wide
        preset = simulate.write_widened_preset(os.path.join(outdir,
                                                            'widened'), SEED)
        widened_rows = check_kernel_shapes(np.random.default_rng(SHAPES_SEED),
                                           preset)
        profile('stage-1, {} reads'.format(BATCH),
                lambda: analyzer.engine.run_stage1_flat(
                    stage1_inputs[:BATCH]))
        profile_batch(analyzer, list(reads.values())[:BATCH])
        del analyzer
        shipped_rate = session_through_cli(config, results, reads, outdir,
                                           card)
        widened_launches = session_widened(preset, reads, shipped_rate, card)
        host_stages_through_cli(config, results, reads, outdir, card)
        check_ingest_turns(reads, outdir, card)
        check_every_card(config)
        check_mesh(config, list(reads.values()), card)
        check_ranks(card)

    training_step_parity()
    with tempfile.TemporaryDirectory() as outdir:
        serve_trained(*train_on_card(outdir))
    check_data_parallel(card, [1])
    log(libhdf5_line())
    log(native_reader_line())

    kernels_line = []
    seen = set()
    for row in rows:
        if row['name'] in seen:     # the main shape's row is the first
            continue
        seen.add(row['name'])
        bound_ms, bound_by = bound(row['flops'], row['nbytes'])
        kernels_line.append({
            'name': row['name'], 'route': row['route'],
            'source': row['source'], 'replaces': row['replaces'],
            'launches': launches[row['name']],
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': row['library_ms']})
    for row in widened_rows:
        bound_ms, bound_by = bound(row['flops'], row['nbytes'])
        kernels_line.append({
            'name': row['json_name'], 'route': row['route'],
            'source': row['source'], 'replaces': row['replaces'],
            'launches': widened_launches[row['name']],
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': row['library_ms']})
    log('chip_smoke took {:.1f} s'.format(time.perf_counter() - t0))
    print(json.dumps({'kernels': kernels_line}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
