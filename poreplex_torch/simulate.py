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


def tie_hmm(ncomp):
    """A 6-state HMM with ncomp mixture components whose states 1 and 2
    have equal start probabilities, emissions and transitions (out of and
    into each): their scores are equal on every frame, so every argmax
    over predecessors that reaches them ties, the lower state must win and
    state 2 never appears in a path. Returns float32 arrays (log_start,
    log_trans [from, to], mus, sigmas, log_weights), the Viterbi entries'
    parameters."""
    start = np.array([0.4, 0.2, 0.2, 0.1, 0.05, 0.05])
    trans = np.full((6, 6), 0.02)
    np.fill_diagonal(trans, 0.9)
    trans[:, 2] = trans[:, 1]
    trans[2, :] = trans[1, :]
    trans /= trans.sum(axis=1, keepdims=True)
    mus = np.array([[70, 60], [100, 90], [100, 90], [80, 65], [110, 105],
                    [95, 85]])[:, :ncomp]
    sigmas = np.array([[3, 4], [4, 5], [4, 5], [7, 3], [2.5, 3],
                       [10, 12]])[:, :ncomp]
    logws = np.log(np.full((6, ncomp), 1.0 / ncomp))
    return [a.astype(np.float32)
            for a in (np.log(start), np.log(trans), mus, sigmas, logws)]


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
