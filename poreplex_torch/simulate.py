"""Synthetic nanopore direct-RNA reads.

A read's signal follows the segmentation HMM's state sequence (pre-leader
-> leader -> adapter -> poly(A) -> transcript) and carries an albacore-style
basecall of its transcript region. Reads are served from memory through
``MemoryRead`` (the reader surface the analyzer loads from) or written as
FAST5 files (h5py imported only there). Random numbers come only from the
``numpy.random.Generator`` the caller passes.
"""

import os
import uuid

import numpy as np

from .fast5 import EventTable, dac_to_pa

DIGITISATION = 8192.0
RANGE = 1169.0
OFFSET = 3.0
SAMPLING_RATE = 3012.0

STATE_LEVELS = {
    'pre-leader': (71.5, 3.66),
    'leader-low': (102.07, 3.91),
    'leader-high': (112.02, 4.80),
    'adapter': (80.49, 7.41),
    'polya-tail': (108.95, 2.55),
    'transcript': (96.0, 11.0),
}

# per-barcode low-frequency signature on the adapter, in cycles per pooled
# frame (stride 15), and its amplitude in pA
BARCODE_FREQS = [0.011, 0.023, 0.037, 0.053]
BARCODE_AMPS = [6.0, 5.0, 4.5, 5.5]

BASES = 'ACGT'

# albacore Events table layout (14 columns)
EVENT_DTYPE = [('mean', '<f8'), ('start', '<u8'), ('stdv', '<f8'),
               ('length', '<u8'), ('model_state', 'S5'), ('move', '<i8'),
               ('p_model_state', '<f8')] + [
    (c, '<f8') for c in ('weights', 'p_A', 'p_C', 'p_G', 'p_U', 'raw_index',
                         'prev_state')]
MEAN_QSCORE = 9.5
BLOCK_STRIDE = 10


class SimulatedRead:

    def __init__(self, read_id, run_id, raw_dac, segments, sequence,
                 qstring, events, channel='101', sample_id='simulated',
                 start_time=0):
        self.read_id = read_id
        self.raw_dac = raw_dac
        self.segments = segments          # {state: (start_sample, end_sample)}
        self.sequence = sequence
        self.qstring = qstring
        self.events = events              # albacore Events table (structured)
        self.channel = channel
        self.run_id = run_id
        self.sample_id = sample_id
        self.start_time = start_time

    @property
    def duration(self):
        return len(self.raw_dac)


def tie_hmm(ncomp, nstates=6):
    """A 6-state HMM with ncomp mixture components whose states 1 and 2
    have equal start probabilities, emissions and transitions (out of and
    into each): their scores are equal on every frame, so every argmax
    over predecessors that reaches them ties, the lower state must win and
    state 2 never appears in a path. nstates 7 or 8 appends states at 90
    and 120 pA (then the start probabilities are normalised); a third
    component and on sits 7 pA a component above the first, and then the
    first weighs 0.8, the others share 0.2 (at equal weights the tied
    states of 8 lose their reads to their neighbours). Returns
    float32 arrays (log_start, log_trans [from, to], mus, sigmas,
    log_weights), the Viterbi entries' parameters."""
    start = np.array([0.4, 0.2, 0.2, 0.1, 0.05, 0.05, 0.05, 0.05])[:nstates]
    if nstates > 6:
        start = start / start.sum()
    trans = np.full((nstates, nstates), 0.02)
    np.fill_diagonal(trans, 0.9)
    trans[:, 2] = trans[:, 1]
    trans[2, :] = trans[1, :]
    trans /= trans.sum(axis=1, keepdims=True)
    mus = np.array([[70, 60], [100, 90], [100, 90], [80, 65], [110, 105],
                    [95, 85], [90, 75], [120, 115]])[:nstates]
    sigmas = np.array([[3, 4], [4, 5], [4, 5], [7, 3], [2.5, 3],
                       [10, 12], [5, 6], [3, 4]])[:nstates]
    extra = np.arange(1, max(ncomp - 2, 0) + 1)
    mus = np.concatenate([mus, mus[:, :1] + 7.0 * extra], axis=1)[:, :ncomp]
    sigmas = np.concatenate([sigmas, sigmas[:, :1] + extra],
                            axis=1)[:, :ncomp]
    weights = np.full((nstates, ncomp), 1.0 / ncomp)
    if ncomp > 2:   # most of the weight on the first component
        weights[:] = 0.2 / (ncomp - 1)
        weights[:, 0] = 0.8
    logws = np.log(weights)
    return [a.astype(np.float32)
            for a in (np.log(start), np.log(trans), mus, sigmas, logws)]


def random_hmm(rng, nstates, ncomp):
    """A random HMM of nstates states and ncomp mixture components: sticky
    transitions (0.9 to itself, the rest at random), components at 60 to
    125 pA with sigmas 2 to 10 and random weights. Returns float32 arrays
    as tie_hmm does."""
    start = rng.dirichlet(np.ones(nstates))
    trans = rng.dirichlet(np.ones(nstates), nstates) * 0.1
    trans[np.arange(nstates), np.arange(nstates)] += 0.9
    mus = rng.uniform(60.0, 125.0, (nstates, ncomp))
    sigmas = rng.uniform(2.0, 10.0, (nstates, ncomp))
    weights = rng.dirichlet(np.ones(ncomp), nstates)
    return [a.astype(np.float32) for a in
            (np.log(start), np.log(trans), mus, sigmas, np.log(weights))]


def hmm_signal(rng, mus, batch, seqlen, run=20, noise=3.0):
    """[batch, seqlen] float32 signal that dwells ``run`` frames at a time
    on a state's first component mean (mus [S, K]), with Gaussian noise,
    and lengths [batch] int32 from 1 to seqlen (the first read 1, the
    second seqlen)."""
    levels = rng.choice(np.asarray(mus)[:, 0], (batch, seqlen // run + 1))
    x = (np.repeat(levels, run, axis=1)[:, :seqlen] +
         rng.normal(0, noise, (batch, seqlen))).astype(np.float32)
    lengths = rng.integers(1, seqlen + 1, batch).astype(np.int32)
    lengths[:2] = (1, seqlen)[:batch]
    return x, lengths


def dp_cases(rng, rows, kmax, spike_weight=1.5, spike_tolerance=110):
    """Rows of the poly(A) interval DP that stress its ties and its column
    splits: (is_polya bool [rows, kmax], length float32 [rows, kmax],
    n_events int32 [rows]). Row kinds, in turn: random events; equal
    scores from different starts; equal scores and starts to different
    ends; deaths (budget one over spike_tolerance) at the first and last
    column of every 16, 32, 512 and 1024 columns, from one spike or from a
    run that crosses the boundary; a spike run that ends exactly at
    spike_tolerance (no death, no valid end); and event counts of 1, of
    kmax and of kmax minus an odd number. Lengths keep every prefix within
    the DP's exact int32 packing."""
    # spike_weight * longest * kmax bounds |prefix|, which must stay below
    # the point where (prefix + 2**20) * kmax + start overflows
    limit = (2 ** 31 - 1) // kmax - (1 << 20) - 1
    longest = int(min(300.0, limit / (spike_weight * kmax)))
    tol = int(spike_tolerance)
    # a spike whose truncated length scores exactly -w
    small = max(1, min(longest, 6))
    is_polya = np.zeros((rows, kmax), bool)
    length = np.zeros((rows, kmax), np.float32)
    n_events = np.zeros(rows, np.int32)
    boundaries = [c for unit in (16, 32, 512, 1024)
                  for at in range(0, kmax, unit) for c in (at, at + unit - 1)
                  if c < kmax]
    for r in range(rows):
        kind = r % 6
        p = rng.uniform(size=kmax) < 0.6
        if kind == 0:
            ln = rng.uniform(1, longest, kmax).astype(np.float32)
        else:
            ln = rng.integers(1, longest + 1, kmax).astype(np.float32)
        if kind == 1:
            # a poly(A) column, a spike that cancels it exactly, then the
            # same score again: intervals from both starts tie
            for at in range(int(rng.integers(0, 4)), kmax - 2, 7):
                w = int(spike_weight * small)
                p[at:at + 3] = (True, False, True)
                ln[at:at + 3] = (w, small, ln[at + 2])
        elif kind == 2:
            # a poly(A) column, a spike, and a poly(A) column that wins
            # back exactly the spike's score: both ends tie
            for at in range(int(rng.integers(0, 4)), kmax - 2, 5):
                w = int(spike_weight * small)
                p[at:at + 3] = (True, False, True)
                ln[at:at + 3] = (ln[at], small, w)
        elif kind == 3:
            p[:] = True
            for c in boundaries:
                if rng.uniform() < 0.6:
                    continue
                if rng.uniform() < 0.5 or c == 0:
                    p[c], ln[c] = False, tol + 1
                else:
                    # a run crossing into c that dies exactly at c
                    half = (tol + 1) // 2
                    p[c - 1:c + 1] = False
                    ln[c - 1:c + 1] = (half, tol + 1 - half)
        elif kind == 4:
            at = int(rng.integers(0, max(1, kmax - 3)))
            split = tol // 3
            p[at:at + 3] = False
            ln[at:at + 3] = (split, split, tol - 2 * split)[:len(p[at:at + 3])]
        else:
            # blocks of equal score between deaths, each a start or an end
            # tie across the last column of 16, 32, 512 or 1024 columns:
            # the best is the first block's, from its first column
            p[:], ln[:] = False, tol + 1
            w = int(spike_weight * small)
            lasts = boundaries[1::2]
            for c in sorted(rng.choice(lasts, min(6, len(lasts)),
                                       replace=False)):
                if c + 3 < kmax:
                    p[c:c + 3] = (True, False, True)
                    ln[c:c + 3] = ((longest, small, w) if rng.uniform() < 0.5
                                   else (w, small, longest))
        is_polya[r], length[r] = p, ln
        n_events[r] = (1, kmax, max(1, kmax - 2 * int(rng.integers(0, 8)) - 1),
                       int(rng.integers(1, kmax + 1)))[r % 4]
    scores = np.where(is_polya, length, -np.float32(spike_weight) * length)
    assert np.abs(np.trunc(scores)).sum(axis=1).max() <= limit
    return is_polya, length, n_events


def _to_dac(pa):
    dac = pa / (RANGE / DIGITISATION) - OFFSET
    return np.clip(np.round(dac), -32768, 32767).astype(np.int16)


def simulate_read(rng, transcript_len=9000, polya_len=2500, adapter_len=5500,
                  preleader_len=700, leader_len=900, seq_per_event=0.35,
                  noise=1.0, barcode=None, extra_adapter_at=None):
    """One synthetic read from ``rng`` (a numpy.random.Generator).
    Durations are in raw samples; ``barcode`` (0..3) modulates the adapter
    with that barcode's signature; ``extra_adapter_at`` (a fraction of the
    transcript) puts a second leader and adapter inside the transcript,
    making a read of two molecules for the unsplit-read filter."""
    read_id = str(uuid.UUID(bytes=rng.bytes(16), version=4))
    run_id = uuid.UUID(bytes=rng.bytes(16), version=4).hex
    parts = []
    segments = {}
    layout = [
        ('pre-leader', preleader_len),
        ('leader-low', leader_len * 2 // 3),
        ('leader-high', leader_len - leader_len * 2 // 3),
        ('adapter', adapter_len),
        ('polya-tail', polya_len),
        ('transcript', transcript_len),
    ]
    pos = 0
    for state, dur in layout:
        mu, sd = STATE_LEVELS[state]
        seg = rng.normal(mu, sd * noise, dur)
        if state == 'adapter' and barcode is not None:
            t = np.arange(dur) / 15.0
            seg += BARCODE_AMPS[barcode] * np.sin(
                2 * np.pi * BARCODE_FREQS[barcode] * t +
                rng.uniform(0, 2 * np.pi))
        if state == 'transcript':
            # the transcript wanders between k-mer levels
            nlevels = max(2, -(-transcript_len // 35))
            levels = rng.normal(mu, sd, nlevels)
            seg = np.repeat(levels, 35)[:dur] + rng.normal(0, 2.0, dur)
            if extra_adapter_at is not None:
                at = int(dur * extra_adapter_at)
                ldur = min(900, max(0, dur - at))
                adur = min(4000, max(0, dur - at - ldur))
                seg[at:at + ldur] = rng.normal(*STATE_LEVELS['leader-high'],
                                               ldur)
                seg[at + ldur:at + ldur + adur] = rng.normal(
                    *STATE_LEVELS['adapter'], adur)
        seg_start = pos
        pos += len(seg)
        if state.startswith('leader'):
            segments.setdefault('leader', [seg_start, pos - 1])
            segments['leader'][1] = pos - 1
        else:
            segments[state] = (seg_start, pos - 1)
        parts.append(seg)
    signal_pa = np.concatenate(parts).astype(np.float32)

    # basecalled sequence and events over the transcript region
    tr_start, tr_end = segments['transcript']
    n_events = max(8, int((tr_end - tr_start + 1) / 35))
    moves = (rng.uniform(size=n_events) < seq_per_event).astype(np.uint8)
    moves[0] = 1
    seqlen = int(moves.sum()) + 4     # 5-mer model: k - 1 extra bases
    sequence = ''.join(rng.choice(list(BASES), seqlen))
    qstring = ''.join(chr(33 + q) for q in rng.integers(4, 30, seqlen))

    ev_starts = np.linspace(tr_start, tr_end - 35, n_events).astype(np.int64)
    ev_lengths = np.diff(np.append(ev_starts, tr_end)).astype(np.int64)
    pos_idx = np.cumsum(moves) - 1
    events = np.zeros(n_events, dtype=EVENT_DTYPE)
    events['model_state'] = [
        sequence[min(p, seqlen - 5):min(p, seqlen - 5) + 5].encode()
        for p in pos_idx]
    events['mean'] = [signal_pa[s:s + max(l, 1)].mean()
                      for s, l in zip(ev_starts, ev_lengths)]
    events['stdv'] = [signal_pa[s:s + max(l, 1)].std()
                      for s, l in zip(ev_starts, ev_lengths)]
    events['start'] = ev_starts
    events['length'] = ev_lengths
    events['move'] = moves
    events['p_model_state'] = rng.uniform(0.2, 0.95, n_events)

    return SimulatedRead(read_id, run_id, _to_dac(signal_pa), segments,
                         sequence, qstring, events)


class MemoryRead:
    """A simulated read behind the reader surface the analyzer loads from
    (the attributes and methods of fast5.Fast5Reader that it uses)."""

    def __init__(self, read):
        self.read = read
        self.read_id = read.read_id
        self.duration = read.duration
        self.start_time = read.start_time
        self.channel_number = read.channel
        self.sampling_rate = SAMPLING_RATE
        self.run_id = read.run_id
        self.sample_id = read.sample_id
        self.offset = OFFSET
        self.range = RANGE
        self.digitisation = DIGITISATION
        self.pa_scale = RANGE / DIGITISATION

    def get_raw_dac(self):
        return self.read.raw_dac

    def get_raw_data(self):
        return dac_to_pa(self.read.raw_dac, RANGE, DIGITISATION, OFFSET)

    def get_basecall(self, columns=None):
        read = self.read
        names = columns or read.events.dtype.names
        return {
            'sequence': read.sequence,
            'qstring': read.qstring,
            'block_stride': BLOCK_STRIDE,
            'sequence_length': len(read.sequence),
            'mean_qscore': MEAN_QSCORE,
            'num_events': len(read.events),
            'first_sample_template': int(read.segments['transcript'][0]),
            'events': EventTable({n: read.events[n].copy() for n in names}),
        }

    def close(self):
        pass


# ---------------------------------------------------------------- FAST5

def _write_basecall(parent, read, basecall='albacore'):
    """Analyses/{Basecall_1D_000,Segmentation_000} with an albacore
    Events table, or with a guppy Move table (``basecall='guppy'``)."""
    analyses = parent.require_group('Analyses')
    bc = analyses.require_group('Basecall_1D_000')
    seg = analyses.require_group('Segmentation_000')
    if basecall == 'guppy':
        bc.create_dataset('BaseCalled_template/Move',
                          data=read.events['move'].astype(np.uint8))
    else:
        bc.create_dataset('BaseCalled_template/Events', data=read.events)
    fastq = '@{}\n{}\n+\n{}\n'.format(read.read_id, read.sequence,
                                      read.qstring)
    bc.create_dataset('BaseCalled_template/Fastq', data=np.bytes_(fastq))
    summ = bc.require_group('Summary/basecall_1d_template')
    summ.attrs['sequence_length'] = len(read.sequence)
    summ.attrs['mean_qscore'] = MEAN_QSCORE
    summ.attrs['block_stride'] = BLOCK_STRIDE
    segsum = seg.require_group('Summary/segmentation')
    segsum.attrs['num_events_template'] = len(read.events)
    segsum.attrs['first_sample_template'] = int(
        read.segments['transcript'][0])


def _write_channel_tracking(parent, prefix, read):
    ch = parent.require_group(prefix + 'channel_id')
    ch.attrs['channel_number'] = np.bytes_(read.channel)
    ch.attrs['digitisation'] = DIGITISATION
    ch.attrs['offset'] = OFFSET
    ch.attrs['range'] = RANGE
    ch.attrs['sampling_rate'] = SAMPLING_RATE
    tr = parent.require_group(prefix + 'tracking_id')
    tr.attrs['run_id'] = np.bytes_(read.run_id)
    tr.attrs['sample_id'] = np.bytes_(read.sample_id)


def _write_raw(raw, read):
    raw.attrs['read_id'] = np.bytes_(read.read_id)
    raw.attrs['duration'] = read.duration
    raw.attrs['start_time'] = read.start_time
    raw.create_dataset('Signal', data=read.raw_dac)


def write_single_read_fast5(path, read, basecall='albacore'):
    """Single-read layout: UniqueGlobalKey + Raw/Reads/Read_N."""
    import h5py
    with h5py.File(path, 'w') as f5:
        _write_raw(f5.create_group('Raw/Reads/Read_1001'), read)
        _write_channel_tracking(f5, 'UniqueGlobalKey/', read)
        _write_basecall(f5, read, basecall)


def write_multi_read_fast5(path, reads, basecall='albacore'):
    """Multi-read layout: one read_<id> group a read."""
    import h5py
    with h5py.File(path, 'w') as f5:
        for read in reads:
            grp = f5.create_group('read_' + read.read_id)
            _write_raw(grp.create_group('Raw'), read)
            _write_channel_tracking(grp, '', read)
            _write_basecall(grp, read, basecall)


def make_fixture_dir(outdir, n_reads=8, seed=0, basecall='albacore',
                     multi_read=False, **simkw):
    """A directory of FAST5 files, one a read or (``multi_read``) all in
    one multi-read file, with albacore or guppy basecalls; returns the
    (filename, read_id) entries."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    reads = [simulate_read(rng, **simkw) for _ in range(n_reads)]
    if multi_read:
        fname = 'batch0.fast5'
        write_multi_read_fast5(os.path.join(outdir, fname), reads, basecall)
        return [(fname, read.read_id) for read in reads]
    entries = []
    for i, read in enumerate(reads):
        fname = 'read{:03d}.fast5'.format(i)
        write_single_read_fast5(os.path.join(outdir, fname), read, basecall)
        entries.append((fname, read.read_id))
    return entries


# ----------------------------------------------------------------------
# a preset at other widths and HMM shapes than the shipped one

WIDENED_SCALER_HIDDEN = 96
WIDENED_SEQ_HIDDEN = 56
WIDENED_LAST_HIDDEN = 128


def _widen_lstm(rng, params, layer, in_rows, inputs, hidden):
    """The LSTM layer ``layer`` of ``params`` (flat '<layer>/<key>' arrays,
    Keras gate order) at ``inputs`` inputs and ``hidden`` units: old input
    row i moves to row in_rows[i]; the new units take seeded weights on
    every input and recurrence, of the old matrices' spreads scaled to the
    wider fan-in (by the square root of old over new rows, as initialisers
    scale them), and every weight from a new input or unit into an old
    unit is zero, so the old units compute what they did."""
    kernel, rec, bias = (np.asarray(params[layer + '/' + key], np.float64)
                         for key in ('kernel', 'recurrent', 'bias'))
    i0, h0 = kernel.shape[0], rec.shape[0]
    k = rng.normal(0, kernel.std() * (i0 / inputs) ** 0.5,
                   (inputs, 4, hidden))
    r = rng.normal(0, rec.std() * (h0 / hidden) ** 0.5, (hidden, 4, hidden))
    b = rng.normal(0, bias.std(), (4, hidden))
    k[:, :, :h0] = 0.0
    r[:, :, :h0] = 0.0
    k[in_rows, :, :h0] = kernel.reshape(i0, 4, h0)
    r[:h0, :, :h0] = rec.reshape(h0, 4, h0)
    b[:, :h0] = bias.reshape(4, h0)
    return {layer + '/kernel': k.reshape(inputs, 4 * hidden),
            layer + '/recurrent': r.reshape(hidden, 4 * hidden),
            layer + '/bias': b.reshape(4 * hidden)}


def _widen_dense(params, in_rows, inputs):
    kernel = np.asarray(params['dense/kernel'])
    k = np.zeros((inputs, kernel.shape[1]))
    k[in_rows] = kernel
    return {'dense/kernel': k, 'dense/bias': np.asarray(params['dense/bias'])}


def widened_networks(rng, scaler, demux):
    """The shipped networks' bundles (``np.load`` mappings) widened: the
    scaler's two LSTM(48) to LSTM(96), the demultiplexer's BiLSTM(48) to
    BiLSTM(56) and its LSTM(64) to LSTM(128), each new unit with seeded
    weights into it and zero weights out of it into an old unit or the
    Dense layer. The widened networks compute the shipped functions up to
    float32 association. Returns the two bundles' arrays."""
    hs, hb, hl = (WIDENED_SCALER_HIDDEN, WIDENED_SEQ_HIDDEN,
                  WIDENED_LAST_HIDDEN)
    old_s = scaler['lstm1/recurrent'].shape[0]
    out_s = dict(_widen_lstm(rng, scaler, 'lstm1', [0], 1, hs))
    out_s.update(_widen_lstm(rng, scaler, 'lstm2', np.arange(old_s), hs, hs))
    out_s.update(_widen_dense(scaler, np.arange(old_s), hs))
    out_s['meta'] = scaler['meta']

    old_b = demux['bilstm_fwd/recurrent'].shape[0]
    old_l = demux['lstm2/recurrent'].shape[0]
    out_d = {}
    for layer in ('bilstm_fwd', 'bilstm_bwd'):
        out_d.update(_widen_lstm(rng, demux, layer, [0], 1, hb))
    # the concatenated directions: forward units first, then backward ones
    seq_rows = np.concatenate([np.arange(old_b), hb + np.arange(old_b)])
    out_d.update(_widen_lstm(rng, demux, 'lstm2', seq_rows, 2 * hb, hl))
    out_d.update(_widen_dense(demux, np.arange(old_l), hl))
    for key in ('calibration', 'loss_weights'):
        out_d[key] = demux[key]
    return ({k: np.asarray(v).astype(np.uint8 if k == 'meta' else
                                     np.float32) for k, v in out_s.items()},
            {k: np.asarray(v).astype(np.float64 if k == 'calibration' else
                                     np.float32) for k, v in out_d.items()})


def _state(spec, name):
    return next(s for s in spec if s['name'] == name)


def _insert_leader_mid(spec, start_prob=None):
    """The state list with 'leader-mid' after 'leader-low': emission the
    mean of leader-low's and leader-high's, 0.99 to itself and 0.01 on to
    leader-high; leader-low's way on to leader-high is split between it
    and leader-mid."""
    low, high = _state(spec, 'leader-low'), _state(spec, 'leader-high')
    (mu_l, sd_l), (mu_h, sd_h) = low['emission'][0], high['emission'][0]
    mid = {'name': 'leader-mid',
           'emission': [[(mu_l + mu_h) / 2.0, (sd_l + sd_h) / 2.0]],
           'transition': [['leader-mid', 0.99], ['leader-high', 0.01]]}
    if start_prob is not None:
        mid['start_prob'] = start_prob
    on = [p for nxt, p in low['transition'] if nxt == 'leader-high'][0]
    low['transition'] = [t for t in low['transition']
                         if t[0] != 'leader-high'] + \
        [['leader-mid', on / 2.0], ['leader-high', on / 2.0]]
    at = spec.index(low) + 1
    return spec[:at] + [mid] + spec[at:]


def widened_hmms(segmentation, unsplit):
    """The shipped HMM state lists widened: the segmentation model's to 7
    states (leader-mid) with a third mixture component of 'transcript'
    (weight 0.05, 95.0 pA, sigma 10.0), K = 3; the unsplit model's to 8
    states (leader-mid, and 'transcript-b', entered from and left to
    'transcript' at 0.01, with 4 components), K = 4."""
    import copy
    seg = _insert_leader_mid(copy.deepcopy(segmentation))
    _state(seg, 'transcript')['emission'].append([95.0, 10.0, 0.05])
    uns = _insert_leader_mid(copy.deepcopy(unsplit), start_prob=0.01)
    _state(uns, 'transcript')['transition'].append(['transcript-b', 0.01])
    uns.append({'name': 'transcript-b', 'start_prob': 0.01,
                'emission': [[82.0, 8.0, 0.4], [110.0, 12.0, 0.4],
                             [95.0, 10.0, 0.1], [70.0, 6.0, 0.1]],
                'transition': [['transcript-b', 0.99],
                               ['transcript', 0.01]]})
    return seg, uns


def write_widened_preset(directory, seed=0):
    """The shipped rna-r941 preset with the networks of widened_networks
    (new units seeded from ``seed``) and the HMMs of widened_hmms, at the
    shipped lengths: ``<directory>/rna-r941-widened.json`` and its two
    .npz bundles beside it (absolute paths in the preset). Returns the
    preset's path."""
    import json
    from .config import PRESETS_DIR
    with open(os.path.join(PRESETS_DIR, 'rna-r941.json')) as f:
        config = json.load(f)
    os.makedirs(directory, exist_ok=True)
    bundles = {}
    for section, key in (('signal_processing', 'scaler_model'),
                         ('demultiplexing', 'demux_model')):
        bundles[key] = np.load(os.path.join(PRESETS_DIR,
                                            config[section][key]))
    scaler, demux = widened_networks(np.random.default_rng(seed),
                                     bundles['scaler_model'],
                                     bundles['demux_model'])
    for section, key, arrays in (
            ('signal_processing', 'scaler_model', scaler),
            ('demultiplexing', 'demux_model', demux)):
        path = os.path.abspath(os.path.join(directory, key + '.npz'))
        np.savez(path, **arrays)
        config[section][key] = path
    config['preset_name'] = 'rna-r941-widened'
    config['segmentation_model'], config['unsplit_read_detection_model'] = \
        widened_hmms(config['segmentation_model'],
                     config['unsplit_read_detection_model'])
    path = os.path.join(directory, 'rna-r941-widened.json')
    with open(path, 'w') as f:
        json.dump(config, f, indent=2)
    return path


def preset_yaml(json_path):
    """The YAML form of a JSON preset, beside it, for poreplex-tpu's
    loader (needs PyYAML, which the port does not); returns its path."""
    import json
    import yaml
    with open(json_path) as f:
        config = json.load(f)
    path = os.path.splitext(json_path)[0] + '.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(config, f, sort_keys=False)
    return path
