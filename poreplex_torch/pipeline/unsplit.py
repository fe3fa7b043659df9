"""Unsplit-read ("pseudo-fusion") detection, with the semantics of
poreplex-tpu's ``pipeline/unsplit.py`` (the reference's windowed scan,
poreplex/signal_analyzer.py:366-443).

Sliding windows over each read's post-adapter basecalled events are
gathered across the batch and decoded with the unsplit HMM through the
full-path Viterbi kernel, one launch per event bucket and chunk of rows:
each read's scaled event means cross to the device once and a window is an
(offset, length) slice of that stream. The leader -> adapter run walk then
runs as tensor operations over the decoded paths, and only a [R, K, 3]
table of (leader_start, first, last) trios plus run counts comes back; a
window with more than K adapter runs takes the host walk over its path.
The duration cutoffs and the high-quality base counts stay on the host.
Over several devices each launch's rows are cut into one contiguous block
a device, and every launch is enqueued before the first read-back.
"""

import copy

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import block_rows
from ..utils import union_intervals


class UnsplitReadDetector:

    # event-count buckets of the padded window shape; larger counts round
    # up to the next power of two
    EVENT_BUCKETS = (128, 1024)
    # windows per launch and device
    ROWS = 1024
    # adapter runs reported per window; windows with more walk their path
    # on the host
    MAX_RUNS = 16

    def __init__(self, config, unsplit_model, devices=None):
        """``devices``: the windows' devices (default the model's), each
        with its own copy of the HMM."""
        self.config = config['unsplit_read_detection']
        self.devices = list(devices or [unsplit_model.mus.device])
        index = unsplit_model.state_index
        self.leaderish = {index[n] for n in ('adapter', 'leader-high',
                                             'leader-low') if n in index}
        self.adapter_idx = index['adapter']
        mask = torch.zeros(unsplit_model.nstates, dtype=torch.bool)
        mask[sorted(self.leaderish)] = True
        # device -> (HMM, leader mask) on it
        self._on = {}
        for device in self.devices:
            if device not in self._on:
                model = (unsplit_model if device == unsplit_model.mus.device
                         else copy.deepcopy(unsplit_model).to(device))
                self._on[device] = model, mask.to(device)

    # ------------------------------------------------------------------
    def collect_windows(self, read, segments, elspan):
        """The sliding event windows of one read (poreplex/
        signal_analyzer.py:369-387) as contiguous [lo, hi) slices of its
        event table (event starts are sorted): (payload_start, windows),
        or (None, None) for an adapter-only read."""
        try:
            payload_start = (segments['adapter'][1] + 1) * elspan
        except (KeyError, IndexError):
            return None, None
        rate = read.sampling_rate
        window_size = int(self.config['window_size'] * rate)
        window_step = int(self.config['window_step'] * rate)
        starts = np.asarray(read.events['start'], np.int64)
        last_end = int(np.asarray(read.events['end'], np.int64)[-1])

        windows = []
        for left in range(payload_start, last_end, window_step):
            lo = int(np.searchsorted(starts, left, side='left'))
            hi = int(np.searchsorted(starts, left + window_size,
                                     side='right'))
            if hi - lo < 1:
                break
            windows.append((lo, hi))
        return payload_start, windows

    @classmethod
    def _event_bucket(cls, n):
        for b in cls.EVENT_BUCKETS:
            if n <= b:
                return b
        return 1 << (n - 1).bit_length()

    # ------------------------------------------------------------------
    def decode_runs_batched(self, jobs):
        """jobs: list of (read, lo, hi) event windows. Returns one [k, 3]
        int64 array of (leader_start, first, last) trios per job, indices
        relative to the window."""
        runs = [None] * len(jobs)
        by_bucket = {}
        for i, (_, lo, hi) in enumerate(jobs):
            by_bucket.setdefault(self._event_bucket(hi - lo), []).append(i)
        rows = self.ROWS * len(self.devices)
        launched = []
        with torch.inference_mode():
            for emax, idx in sorted(by_bucket.items()):
                for at in range(0, len(idx), rows):
                    chunk = idx[at:at + rows]
                    for device, (lo, hi) in zip(
                            self.devices, block_rows(len(chunk),
                                                     len(self.devices))):
                        if hi > lo:
                            launched.append(self._decode(
                                jobs, chunk[lo:hi], emax, device))
        for block, path, lens, trios, count in launched:
            trios, count = trios.cpu().numpy(), count.cpu().numpy()
            for r, i in enumerate(block):
                n = int(count[r])
                if n > self.MAX_RUNS:
                    runs[i] = self._runs_from_path(
                        path[r, :int(lens[r])].cpu().numpy())
                else:
                    runs[i] = trios[r, :n].astype(np.int64)
        return runs

    def _decode(self, jobs, block, emax, device):
        """Enqueues the Viterbi paths and the run walk of the windows
        ``block`` on ``device``: (block, path, lens, trios, count), all
        still on the device."""
        model, mask = self._on[device]
        x, lens = self._pack(jobs, block, emax, device)
        path, _ = model.path(x, lens)
        trios, count = self._runs_on_device(path, lens, mask)
        return block, path, lens, trios, count

    def _pack(self, jobs, chunk, emax, device):
        """Padded windows [rows, emax] on ``device``, gathered from one
        stream holding each read's scaled event means once."""
        offsets, parts, used = {}, [], 0
        meta = np.zeros((len(chunk), 2), np.int64)
        for r, i in enumerate(chunk):
            read, lo, hi = jobs[i]
            if id(read) not in offsets:
                vals = np.asarray(read.events['scaled_mean'], np.float32)
                offsets[id(read)] = used
                parts.append(vals)
                used += len(vals)
            meta[r] = (offsets[id(read)] + lo, hi - lo)
        stream = torch.from_numpy(np.concatenate(parts)).to(device)
        meta = torch.from_numpy(meta).to(device)
        j = torch.arange(emax, device=device)[None, :]
        idx = (meta[:, :1] + j).clamp(0, stream.shape[0] - 1)
        lens = meta[:, 1]
        return torch.where(j < lens[:, None], stream[idx], 0.0), lens

    def _runs_on_device(self, path, lens, leader_mask):
        """The reference's run walk (poreplex/signal_analyzer.py:388-404)
        over decoded paths [R, T]: an adapter run emits (leader_start,
        first, last), leader_start opening the chain of leaderish runs
        that ends in it (broken by a non-leaderish frame or an earlier
        adapter run). Returns (trios [R, K, 3], run counts [R])."""
        rows, seqlen = path.shape
        K = self.MAX_RUNS
        j = torch.arange(seqlen, device=path.device)[None, :]
        valid = j < lens[:, None]
        is_ad = (path == self.adapter_idx) & valid
        leaderish = leader_mask[path] & valid
        run_start = is_ad & ~F.pad(is_ad[:, :-1], (1, 0))
        run_end = is_ad & ~F.pad(is_ad[:, 1:], (0, 1))
        # last chain-breaking frame strictly before each frame
        bound = ~leaderish | is_ad
        lastb = torch.cummax(torch.where(bound, j, -1), dim=1).values
        leader_start = F.pad(lastb[:, :-1], (1, 0), value=-1) + 1

        def slots(flags):
            idx = torch.cumsum(flags.to(torch.int64), dim=1) - 1
            return torch.where(flags, idx.clamp(max=K), K)

        def table(slot, values):
            out = torch.full((rows, K + 1), -1, dtype=torch.int64,
                             device=path.device)
            return out.scatter_reduce(1, slot, values, 'amax')[:, :K]

        jb = j.expand(rows, seqlen)
        sslot = slots(run_start)
        trios = torch.stack([table(sslot, leader_start), table(sslot, jb),
                             table(slots(run_end), jb)], dim=2)
        return trios, run_start.sum(dim=1)

    def _runs_from_path(self, path):
        """The reference's run walk on the host, for windows with more
        adapter runs than the device table holds."""
        trios = []
        leader_start = None
        for first, last, state in _iter_runs(path):
            if state not in self.leaderish:
                leader_start = None
                continue
            if leader_start is None:
                leader_start = first
            if state != self.adapter_idx:
                continue
            trios.append((leader_start, first, last))
            leader_start = None
        return np.asarray(trios, np.int64).reshape(-1, 3)

    # ------------------------------------------------------------------
    def analyze_read(self, read, payload_start, windows, runs):
        """From a read's window trios: True when it is an unsplit artifact
        (poreplex/signal_analyzer.py:388-443)."""
        config = self.config
        rate = read.sampling_rate
        _ = lambda name: int(config[name] * rate)
        strict_duration = _('strict_duration')
        duration_cutoffs = [
            (_('loosen_full_length'), _('loosen_dna_length')),
            (_('strict_full_length'), _('strict_dna_length'))]

        ev = read.events
        starts = np.asarray(ev['start'], np.int64)
        ends = np.asarray(ev['end'], np.int64)

        excessive_adapters = []
        for (lo, hi), wruns in zip(windows, runs):
            for leader_start, first, last in wruns:
                adapter_end = int(ends[lo + last])
                leader_start_in_read = int(starts[lo + leader_start])
                total_duration = adapter_end - leader_start_in_read
                adapter_duration = adapter_end - starts[lo + first]
                total_cutoff, adapter_cutoff = duration_cutoffs[
                    (leader_start_in_read - payload_start) <=
                    strict_duration]
                if (total_duration >= total_cutoff and
                        adapter_duration >= adapter_cutoff):
                    excessive_adapters.append(
                        [leader_start_in_read, 1 + adapter_end])

        if not excessive_adapters:
            return False

        adapter_intervals = (
            [[0, payload_start]] + union_intervals(excessive_adapters) +
            [[np.inf, np.inf]])
        basequality_cutoff = config['basecount_quality_limit']
        pos_all = np.asarray(ev['pos'])
        qual_all = np.asarray(ev['p_model_state'])

        def count_high_quality_reads(sel):
            # per-position max of p_model_state over the selected events
            # (a pandas groupby('pos').max() in the reference); pos is
            # non-decreasing and sel a contiguous range, so the groups are
            # contiguous runs
            if len(sel) == 0:
                return 0
            pos = pos_all[sel]
            qual = qual_all[sel]
            starts_at = np.nonzero(
                np.concatenate([[True], pos[1:] != pos[:-1]]))[0]
            grp_max = np.maximum.reduceat(qual, starts_at)
            return int((grp_max > basequality_cutoff).sum())

        subread_lengths = []
        for (_l, left), (right, _r) in zip(adapter_intervals[0:],
                                           adapter_intervals[1:]):
            sel = np.nonzero((starts >= left) & (starts <= right))[0]
            subread_lengths.append(count_high_quality_reads(sel))

        subread_hq_length_total = sum(subread_lengths[1:])
        return (subread_hq_length_total > config['subread_basecount_limit'] or
                (subread_hq_length_total + 1) / (subread_lengths[0] + 1) >
                config['subread_baseratio_limit'])


def _iter_runs(path):
    """(first, last, state) of each contiguous run of a path."""
    t = 0
    n = len(path)
    while t < n:
        s = path[t]
        first = t
        while t + 1 < n and path[t + 1] == s:
            t += 1
        yield first, t, int(s)
        t += 1
