"""Poly(A) dwell-time measurement: the reference's recursive per-read
analyzer (poreplex/polya.py:30-187) run as synchronous rounds over a
batch, with the decision lattice of poreplex-tpu's ``pipeline/polya.py``.

Each round packs every active window's raw samples into one u16 stream
(integer DAC windows losslessly, float32 windows over their [min, max])
with a [R, 7] window table per window bucket, launches one fused
``polya_round`` per bucket (event detection, tail marking, interval DP,
stdv QC, spike bookkeeping and the anchor recalibration, on the analyzer's
devices), and replays the reference's extend / recalibrate / accept /
reject decisions on the returned scalars. Windows that extend or whose
event table was truncated form the next round, until none are left.

Over several devices a launch's rows are cut into contiguous blocks, one a
device, each block with its own window stream; every launch of a round is
enqueued on every device before the first result is read back. On a card
a block replays a captured CUDA graph of the round
(``ops.polya_round.RoundGraph``), its rows padded with empty windows up to
its row capacity (``row_capacity``); CPU tensors run the round op by op.
"""

import numpy as np
import torch

from ..config import resolve_device
from ..ops import event_detection as ed_ops
from ..ops import polya_round as round_ops
from ..parallel.sharding import block_rows
from ..utils import GLOBAL_TIMER, trace
from .engine import DeviceEngine

# window buckets: a window is padded to the smallest bucket that holds it
_BUCKETS = (8192, 16384, 32768, 131072)

# event-table width per bucket. A window whose true peak count exceeds its
# width (RoundRow.peaks_truncated) is retried in the next bucket with a
# wider table, so truncation never decides a result below the top bucket
_BUCKET_PEAKS = {8192: 511, 16384: 1023, 32768: 1023, 131072: 1023}

# spike rows kept per decision pack; an accepted interval with more spikes
# recomputes its spike list from the window's full event table
_MAX_SPIKES = 128

# window cap: the interval DP packs (prefix + VOFF) * kmax + j into int32,
# which overflows once spike_weight * window_length exceeds
# 2**31 / kmax - VOFF; with kmax = 1024 and spike_weight = 1.5 that bounds
# windows at about 699k samples, so longer right-extensions truncate here
_PACK_SAFE_LEN = 5 * 131072

# windows per launch and device: rows x bucket stays within 2**21 samples,
# which bounds the round's device memory (the median filter holds 7
# copies)
_LAUNCH_SAMPLES = 1 << 21

# the fewest rows of a captured round
_MIN_CAPACITY = 8


def _bucket_len(n):
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + _BUCKETS[-1] - 1) // _BUCKETS[-1]) * _BUCKETS[-1]


def launch_rows(blen):
    """The most windows of bucket ``blen`` in one launch on one device."""
    return max(1, _LAUNCH_SAMPLES // blen)


def row_capacity(rows, blen):
    """The rows of the captured round that runs a launch block of ``rows``
    windows: the next power of two, at least _MIN_CAPACITY and at most the
    launch cap, so that each bucket has a few graphs that every round
    reuses."""
    return min(launch_rows(blen),
               max(_MIN_CAPACITY, 1 << (rows - 1).bit_length()))


def quantize(signal, affine):
    """The u16 wire of one window, (q, (lo, step)), with the (a, b) affine
    onto scaled pA folded into the dequantization v = lo + q * step, in
    float32. An integer DAC window ships losslessly, q = dac - min(dac);
    a float32 window spreads 65535 steps over its [min, max]
    (DeviceEngine._quantize_stream)."""
    a, b = np.float32(affine[0]), np.float32(affine[1])
    q = np.zeros(len(signal), np.uint16)
    if signal.dtype.kind in 'iu':
        low = int(signal.min()) if len(signal) else 0
        q[:] = signal.astype(np.int64) - low
        return q, (a * np.float32(low) + b, a)
    qparams = np.zeros((1, 2), np.float32)
    DeviceEngine._quantize_stream([signal], q, qparams, 65535)
    return q, (a * qparams[0, 0] + b, qparams[0, 1] * a)


class _Task:
    __slots__ = ('read', 'rough_begin', 'rough_end', 'orig_end_none',
                 'polya_range', 'depth', 'signal', 'qaffine', 'insp_begin',
                 'insp_end', 'full_length', 'adapter_end', 'row', 'rounds',
                 'min_bucket', 'wire')

    def __init__(self, read, rough_begin, rough_end, polya_range, depth):
        self.read = read
        self.rough_begin = rough_begin
        self.rough_end = rough_end
        self.orig_end_none = rough_end is None
        self.polya_range = polya_range
        self.depth = depth
        self.rounds = 1
        self.min_bucket = 0     # raised on truncated-table retries
        self.row = None

    def follow(self, rough_end, depth):
        """The task of this read's next round."""
        nt = _Task(self.read, self.rough_begin, rough_end, self.polya_range,
                   depth)
        nt.rounds = self.rounds + 1
        return nt


class PolyaAnalyzer:

    CONFIG_SLOTS = [
        'refinement_expansion', 'event_detection', 'polya_stdv_max',
        'polya_stdv_range', 'spike_tolerance', 'spike_weight',
        'openend_expansion', 'recalibrate_shifted_signal', 'polya_mean_dist',
        'polya_mean_z_cutoff', 'polya_mean_trigger_recalibration',
        'maximum_openend_extension', 'median_pre_filter',
    ]

    def __init__(self, config, device='cuda', devices=None):
        for name in self.CONFIG_SLOTS:
            setattr(self, name, config[name])
        # the rounds' devices; the first also runs the spike fallback
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.max_peaks = 1023

        mean_loc, mean_scale = config['polya_mean_dist']
        self.polya_mean_cutoff = (
            mean_loc - mean_scale * config['polya_mean_z_cutoff'],
            mean_loc + mean_scale * config['polya_mean_z_cutoff'])
        # (poreplex/polya.py:48) the trigger is in units of the sigma
        self.polya_mean_trigger_recalibration = (
            config['polya_mean_trigger_recalibration'] * mean_scale)

        ed = self.event_detection
        rc = self.recalibrate_shifted_signal
        self._detect = dict(
            window_length1=ed['window_length1'],
            window_length2=ed['window_length2'],
            threshold1=float(ed['threshold1']),
            threshold2=float(ed['threshold2']),
            peak_height=float(ed['peak_height']))
        self._round = dict(
            self._detect,
            spike_weight=float(self.spike_weight),
            spike_tolerance=int(self.spike_tolerance),
            median_pre_filter=int(self.median_pre_filter),
            stdv_lo=float(self.polya_stdv_range[0]),
            stdv_hi=float(self.polya_stdv_range[1]),
            recal_max_dist=int(rc['max_dist_from_adapter']),
            recal_max_stdv=float(rc['max_stdv']),
            recal_zr=float(mean_scale * config['polya_mean_z_cutoff']))

    # ------------------------------------------------------------------
    def process_batch(self, items, stride):
        """items: list of (read, rough_range), rough_range (begin,
        end_or_None) in pooled frames. A read exposes ``dac_window`` and
        ``signal_length`` (ReadRecord) or a float32 ``scaled_raw``, plus
        ``sampling_rate`` and ``set_polya_tail``."""
        tasks = [_Task(read, rng[0], rng[1], None, 0) for read, rng in items]
        while tasks:
            with trace('C:polya/window_build'):
                for t in tasks:
                    self._build_window(t, stride)
            with trace('C:polya/round'):
                self._run_round(tasks)
            with trace('C:polya/replay'):
                nexts = [self._replay(t, stride) for t in tasks]
            # a safety net: the depth cap normally ends a chain first
            tasks = [nt for nt in nexts if nt is not None and
                     nt.rounds <= self.maximum_openend_extension]

    # ------------------------------------------------------------------
    def _build_window(self, task, stride):
        """Window arithmetic of poreplex/polya.py:50-63."""
        read = task.read
        slicer = getattr(read, 'dac_window', None)
        if slicer is None:
            raw = read.scaled_raw
            full = len(raw)
            slicer = lambda a, b: (np.asarray(raw[a:b], np.float32),
                                   np.float32(1.0), np.float32(0.0))
        else:
            full = read.signal_length
        meu = self.openend_expansion // stride
        rough_begin, rough_end = task.rough_begin, task.rough_end
        if rough_end is None or rough_end - rough_begin < meu:
            rough_end = rough_begin + meu
        task.rough_end = rough_end

        insp_begin = max(0, rough_begin * stride - self.refinement_expansion)
        task.insp_begin = insp_begin
        task.insp_end = min(full, (rough_end + 1) * stride +
                            self.refinement_expansion,
                            insp_begin + _PACK_SAFE_LEN)
        task.full_length = full
        task.adapter_end = rough_begin * stride - insp_begin
        task.signal, qa, qb = slicer(insp_begin, task.insp_end)
        task.qaffine = (qa, qb)

    def _upload(self, chunks, device):
        """One int32 stream on ``device`` of the concatenated u16 windows;
        a trailing zero keeps it non-empty when every window is."""
        flat = np.concatenate(chunks + [np.zeros(1, np.uint16)]).view(
            np.int16)
        stream = torch.from_numpy(flat).to(device)
        return stream.to(torch.int32) & 0xFFFF

    def _run_round(self, tasks):
        """Launch one fused round per bucket and chunk of windows on every
        device, then read the results back and attach each task's decoded
        RoundRow."""
        by_bucket = {}
        for t in tasks:
            blen = max(_bucket_len(len(t.signal)), t.min_bucket)
            by_bucket.setdefault(blen, []).append(t)
        launched = []
        for blen, group in sorted(by_bucket.items()):
            rows = launch_rows(blen) * len(self.devices)
            for lo in range(0, len(group), rows):
                launched += self._launch(group[lo:lo + rows], blen)
        with trace('C:polya/collect'):
            for chunk, blen, heads, spikes in launched:
                heads, spikes = heads.cpu().numpy(), spikes.cpu().numpy()
                for t, row in zip(chunk, round_ops.unpack_rows(
                        heads, spikes, _MAX_SPIKES)):
                    row.blen = blen
                    t.row = row

    def _launch(self, chunk, blen):
        """Enqueues the round of ``chunk``'s windows, its rows cut into one
        block a device; returns [(the block's tasks, blen, heads, spikes)]
        with the results still on the devices."""
        blocks = []
        for device, (lo, hi) in zip(self.devices, block_rows(
                len(chunk), len(self.devices))):
            if hi == lo:
                continue
            meta = np.zeros((hi - lo, round_ops.META_COLS), np.float32)
            wires, offset = [], 0
            for i, t in enumerate(chunk[lo:hi]):
                # kept for the spike fallback
                t.wire = quantize(t.signal, t.qaffine)
                q, (qlo, qstep) = t.wire
                meta[i] = (offset, len(q), t.adapter_end,
                           *(t.polya_range or self.polya_mean_cutoff), qlo,
                           qstep)
                wires.append(q)
                offset += len(q)
            blocks.append((device, chunk[lo:hi], wires, meta))
        params = dict(self._round, max_spikes=_MAX_SPIKES,
                      max_peaks=_BUCKET_PEAKS.get(blen, self.max_peaks))
        launched = []
        GLOBAL_TIMER.count('C:polya/windows@{}'.format(blen), len(chunk))
        with trace('C:polya/launch'):
            for device, tasks, wires, meta in blocks:
                if device.type == 'cuda':
                    heads, spikes = self._replay_graph(device, wires, meta,
                                                       blen, params)
                else:
                    heads, spikes = round_ops.polya_round(
                        self._upload(wires, device),
                        torch.from_numpy(meta).to(device),
                        blen=blen, **params)
                launched.append((tasks, blen, heads, spikes))
        return launched

    @staticmethod
    def _replay_graph(device, wires, meta, blen, params):
        """The block's round from the captured graph of its row capacity,
        counted as a capture or a replay and by its padding rows."""
        capacity = row_capacity(len(meta), blen)
        graph = round_ops.round_graph(device, blen, capacity, **params)
        heads, spikes, captured = graph(np.concatenate(wires), meta)
        GLOBAL_TIMER.count('C:polya/graph_capture' if captured else
                           'C:polya/graph_replay', 1)
        GLOBAL_TIMER.count('C:polya/graph_pad_rows', capacity - len(meta))
        return heads, spikes

    # ------------------------------------------------------------------
    def _replay(self, t, stride):
        """The reference's decision lattice on this task's round outputs;
        returns the task of the next round (an open-end extension or a
        truncated-table retry), or None when the read is settled."""
        row = t.row
        range_was_set = t.polya_range is not None
        if row.peaks_truncated:
            # the bucket's event table cut this window's events: retry at
            # the same depth in the next bucket whose table is WIDER
            # (padding alone reproduces the same truncated table). No
            # wider bucket: decide on the cut table.
            wider = next(
                (b for b in _BUCKETS if b > row.blen and
                 _BUCKET_PEAKS.get(b, 1023) >
                 _BUCKET_PEAKS.get(row.blen, 1023)), None)
            if wider is not None:
                with trace('C:polya/trunc_retry'):
                    nt = t.follow(t.rough_end, t.depth)
                    nt.orig_end_none = t.orig_end_none
                    nt.min_bucket = wider
                return nt

        if t.orig_end_none:
            # the rough range had no end: straight to the anchor
            # recalibration (poreplex/polya.py:65-68)
            outcome = self._replay_recal(t, row)
        else:
            outcome = self._outcome(t, row.a, range_was_set)
            if outcome == 'recalibrate':
                outcome = self._replay_recal(t, row)
        if outcome != 'extend':
            return None
        meu = self.openend_expansion // stride
        return t.follow(t.rough_end + meu, t.depth + 1)

    def _replay_recal(self, t, row):
        """Anchor recalibration (poreplex/polya.py:127-148) on the round's
        pack-B scalars; returns 'done' or 'extend'."""
        if not row.anchor_any:
            return 'done'
        if row.recal_marked_len < self.recalibrate_shifted_signal[
                'min_length']:
            return 'done'
        t.polya_range = (row.recal_lo, row.recal_hi)
        return self._outcome(t, row.b, True)

    def _outcome(self, t, pack, range_is_set):
        """'done', 'extend' or 'recalibrate' from one decision pack
        (poreplex/polya.py:75-125)."""
        # right-open extension: the interval touches the last event and
        # the window does not reach the end of the signal
        if (pack.valid and pack.e_is_last and
                t.insp_end < t.full_length and
                t.depth < self.maximum_openend_extension):
            return 'extend'

        if not pack.valid or (
                not range_is_set and
                abs(pack.mean_level - self.polya_mean_dist[0]) >
                self.polya_mean_trigger_recalibration):
            return 'recalibrate' if not range_is_set else 'done'

        # stdv QC on the longest event of the interval; NaN compares False
        if pack.longest_stdv < self.polya_stdv_max:
            if pack.spike_count > _MAX_SPIKES:
                with trace('C:polya/spike_fallback'):
                    spikes = self._spikes_fallback(t, pack)
            else:
                spikes = pack.spikes()
            t.read.set_polya_tail({
                'begin': pack.begin_rel + t.insp_begin,
                'end': pack.end_rel + t.insp_begin,
                'dwell_time': pack.dwell / t.read.sampling_rate,
                'spikes': spikes,
            })
            return 'done'
        elif not range_is_set:
            return 'recalibrate'
        return 'done'

    # ------------------------------------------------------------------
    def _spikes_fallback(self, t, pack):
        """More spikes in the accepted interval than the round keeps:
        detect the window's events again from the same wire samples (same
        dequantization and filter, a full-width table) and build the spike
        tuples on the host as poreplex/polya.py:109-116 does."""
        q, (qlo, qstep) = t.wire
        blen = _bucket_len(len(q))
        meta = torch.tensor([[0, len(q), 0, 0, 0, qlo, qstep]],
                            dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            sig, lengths = round_ops.window_signal(
                self._upload([q], self.device), meta, blen,
                int(self.median_pre_filter))
            out = ed_ops.detect_events(sig, lengths, max_peaks=self.max_peaks,
                                       **self._detect)
        mean = out['mean'][0].cpu().numpy()
        length = out['length'][0].cpu().numpy()
        rng = t.polya_range or self.polya_mean_cutoff
        is_polya = (mean >= rng[0]) & (mean <= rng[1])
        s, e = pack.s, pack.e
        spikes = []
        for spk in np.where(~is_polya[s:e + 1])[0]:
            if spk - 1 < 0:
                neighborhood = ()
            else:
                hi = min(s + spk + 2, e + 1)
                neighborhood = tuple(float(v) for v in mean[s + spk - 1:hi])
            spikes.append((float(length[s + spk]),) + neighborhood)
        return spikes
