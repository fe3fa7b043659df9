"""Upstream poreplex's per-read control flow, plain: from a read's raw
signal, metadata and basecall to its sequencing-summary row and FASTQ
record. Read by read as upstream does it, with the networks and HMMs run
over blocks of reads (``nets``); the statuses, labels and output names are
upstream's (poreplex/signal_analyzer.py, poreplex/pipeline.py).

The signal crosses to the networks through the system's stated transport:
each read's pooled frames quantized to 16 bits over its own [min, max]
(``--wire-precision exact``).
"""

import csv
import json
import os

import numpy as np
import torch
from scipy.stats import norm

from . import nets
from .polya import PolyaReference

STATE_ADAPTER = 'adapter'
PAD_FILLER = -1000.0
LABEL_NAMES = {'fail': 'fail', 'pass': 'pass', 'artifact': 'artifact'}


def pool_signal(raw, stride, pa_scale, offset):
    """Stride means of the DAC signal in pA (the affine after the mean)."""
    trimmed = raw[:len(raw) - len(raw) % stride]
    pooled = trimmed.reshape(-1, stride).mean(axis=1, dtype=np.float32)
    return pooled * np.float32(pa_scale) + np.float32(pa_scale * offset)


def quantize(chunk, qmax=65535):
    """(q, lo, step): ``chunk`` on qmax + 1 levels over its [min, max];
    the value carried is lo + q * step in float32."""
    lo = float(chunk.min()) if len(chunk) else 0.0
    hi = float(chunk.max()) if len(chunk) else 0.0
    step = max((hi - lo) / qmax, 1e-7)
    lo32, step32 = np.float32(lo), np.float32(step)
    q = np.clip(np.round((chunk - lo32) / step32), 0, qmax)
    return q.astype(np.float32), lo32, step32


class Reference:
    """The preset's pipeline with the session's options (a configuration
    file's ``analyses``) on ``device``."""

    def __init__(self, preset_path, analyses, device, block=256,
                 polya_precision='float32'):
        with open(preset_path) as f:
            preset = json.load(f)
        base = os.path.dirname(preset_path)
        self.preset = preset
        self.device = torch.device(device)
        self.block = block
        self.barcoding = analyses['barcoding']
        self.polya = analyses['polya']
        self.chimera = analyses['filter_chimera']
        self.min_seq_len = analyses['minimum_length']
        nets.full_fp32()
        sp = preset['signal_processing']
        self.stride = sp['rough_signal_stride']
        self.seg_frames = preset['segmentation']['segmentation_scan_limit'] \
            // self.stride

        scaler = np.load(os.path.join(base, sp['scaler_model']))
        self.scaler = self._layers(scaler, ('lstm1', 'lstm2', 'dense'))
        meta = json.loads(bytes(scaler['meta']).decode())
        self.input_length = int(meta['input']['length'])
        self.min_length = int(meta['input']['min_length'])
        self.head_frames = self.input_length // int(meta['input']['stride'])
        xfrm = meta['output_transform']
        self.xfrm = torch.tensor([[xfrm['scale_std'], xfrm['scale_mean']],
                                  [xfrm['shift_std'], xfrm['shift_mean']]],
                                 dtype=torch.float32, device=self.device)
        q = [sp['scaler_qc_threshold'], 1.0 - sp['scaler_qc_threshold']]
        self.qc_ranges = torch.tensor(np.array([
            norm.ppf(q, xfrm['scale_mean'], xfrm['scale_std']),
            norm.ppf(q, xfrm['shift_mean'], xfrm['shift_std'])]),
            dtype=torch.float32, device=self.device)

        self.seg_names, self.seg_hmm = nets.hmm_arrays(
            preset['segmentation_model'], self.device)
        self.unsplit_names, self.unsplit_hmm = nets.hmm_arrays(
            preset['unsplit_read_detection_model'], self.device)
        self.adapter_idx = self.seg_names.index(STATE_ADAPTER)

        dmx = preset['demultiplexing']
        self.dmx = dmx
        if self.barcoding:
            demux = np.load(os.path.join(base, dmx['demux_model']))
            self.demux = self._layers(
                demux, ('bilstm_fwd', 'bilstm_bwd', 'lstm2', 'dense'))
            self.calibration = np.asarray(demux['calibration'], np.float64)
            self.demux_threshold = float(
                self.calibration[analyses['barcoding_quality_filter']])
        with open(os.path.join(base, 'kmer_models',
                               preset['kmer_model'])) as f:
            rows = csv.reader(f, delimiter='\t')
            next(rows)
            self.kmersize = len(next(rows)[0])
        self.polya_ref = PolyaReference(preset['polya_dwell'],
                                        polya_precision)
        self.unsplit = preset['unsplit_read_detection']

    def _layers(self, data, names):
        return {name: {key.split('/')[1]: torch.tensor(
            np.asarray(data[key], np.float32), device=self.device)
            for key in data.files if key.startswith(name + '/')}
            for name in names}

    # ------------------------------------------------------------------
    def output_name(self, label, barcode):
        """The FASTQ stream of a (label, barcode) pair, relative to
        ``fastq/``."""
        if not self.barcoding:
            return '{}/-.fastq.gz'.format(LABEL_NAMES[label])
        bc = 'undetermined' if barcode is None else 'BC{}'.format(barcode + 1)
        return '{}/{}.fastq.gz'.format(LABEL_NAMES[label], bc)

    @torch.inference_mode()
    def run(self, reads, meta):
        """{i: (row fields, FASTQ (stream, sequence, quality) or None)} of
        reads[i], each a ``harness.simulate.Read``; ``meta`` holds the
        reader's calibration and metadata (pa_scale, offset,
        sampling_rate, channel, start_time, sample_id)."""
        out = {}
        for lo in range(0, len(reads), self.block):
            block = reads[lo:lo + self.block]
            for i, result in enumerate(self._run_block(block, meta)):
                out[lo + i] = result
        return out

    def _run_block(self, reads, meta):
        rate = meta['sampling_rate']
        recs = []
        for read in reads:
            rec = {'status': 'okay', 'stopped': False, 'label': None,
                   'barcode': None, 'polya': None, 'read': read}
            load = min(self.input_length, read.duration)
            load -= load % self.stride
            if load < self.min_length:
                rec.update(status='scaler_signal_too_short', stopped=True)
            else:
                rec['pooled'] = pool_signal(read.raw_dac, self.stride,
                                            meta['pa_scale'], meta['offset'])
            recs.append(rec)
        live = [r for r in recs if not r['stopped']]
        if live:
            self._stage1(live)
        survivors = []
        for rec in live:
            if not rec['qc_ok']:
                rec.update(status='scaling_qc_fail', stopped=True)
                continue
            if self.adapter_idx not in rec['segments']:
                rec['failed'] = 'adapter_not_detected'
                continue
            survivors.append(rec)
        if self.polya:
            for rec in survivors:
                self._polya(rec, meta)
        windows = []
        for rec in survivors:
            self._events(rec, rate)
            if self.chimera:
                windows += self._unsplit_windows(rec, rate)
        if windows:
            self._unsplit(windows, rate)
        for rec in survivors:
            if 'failed' not in rec:
                seq = rec['sequence']
                if len(seq[0]) - seq[2] < self.min_seq_len:
                    rec['failed'] = 'sequence_too_short'
        for rec in live:
            if 'failed' in rec:
                rec.update(status=rec['failed'], stopped=True,
                           label='artifact' if rec['failed'] ==
                           'unsplit_read' else 'fail')
            elif not rec['stopped']:
                rec['label'] = 'pass'
        if self.barcoding:
            for rec in live:
                if rec.get('demux_ok') and 'segments' in rec and \
                        self.adapter_idx in rec['segments'] and \
                        rec['status'] != 'scaling_qc_fail':
                    self._barcode(rec)
        return [self._report(rec, meta) for rec in recs]

    # ------------------------------------------------------------------
    def _stage1(self, recs):
        """Scaler, QC, scaling, segmentation extents and the demux
        network over the block, through the 16-bit transport."""
        dev = self.device
        wire = max(self.seg_frames, self.head_frames)
        B = len(recs)
        pooled = np.zeros((B, wire), np.float32)
        plen = np.zeros(B, np.int64)
        hlen = np.zeros(B, np.int64)
        for i, rec in enumerate(recs):
            p = rec['pooled']
            stored = min(len(p), wire)
            q, lo, step = quantize(p[:stored])
            pooled[i, :stored] = lo + q * step
            plen[i] = min(len(p), self.seg_frames, stored)
            hlen[i] = min(self.head_frames, len(p), stored)
        x = torch.tensor(pooled, device=dev)
        hl = self.head_frames
        j = torch.arange(hl, device=dev)[None, :]
        hlen_t = torch.tensor(hlen, device=dev)
        idx = j - (hl - hlen_t[:, None])
        heads = torch.where(idx >= 0, torch.gather(
            x, 1, idx.clamp(0, wire - 1)), 0.0)
        s = self.scaler
        pred = nets.dense(s['dense'], nets.lstm2_stacked(
            s['lstm1'], s['lstm2'], heads[..., None]))
        scaling = pred * self.xfrm[:, 0] + self.xfrm[:, 1]
        qc_ok = ((scaling >= self.qc_ranges[:, 0]) &
                 (scaling <= self.qc_ranges[:, 1])).all(dim=-1)
        scaled = x[:, :self.seg_frames] * scaling[:, 0:1] + scaling[:, 1:2]
        plen_t = torch.tensor(plen, device=dev)
        path = nets.viterbi(scaled, plen_t, *self.seg_hmm).cpu().numpy()
        scaling_np = scaling.cpu().numpy()
        qc_np = qc_ok.cpu().numpy()
        for i, rec in enumerate(recs):
            rec['scaling'] = scaling_np[i]
            rec['qc_ok'] = bool(qc_np[i])
            rec['segments'] = nets.last_run_extents(path[i], int(plen[i]),
                                                    len(self.seg_names))
        if self.barcoding:
            self._demux(recs, scaled)

    def _demux(self, recs, scaled):
        dev = self.device
        tl = self.dmx['signal_trim_length']
        a0 = np.zeros(len(recs), np.int64)
        a1 = np.zeros(len(recs), np.int64)
        for i, rec in enumerate(recs):
            ext = rec['segments'].get(self.adapter_idx)
            if ext is None:
                rec['demux_ok'] = False
                a0[i], a1[i] = -1, -1
                continue
            a0[i], a1[i] = ext
            alen = ext[1] - ext[0] + 1
            rec['demux_ok'] = (self.dmx['minimum_dna_length'] <= alen <=
                               self.dmx['maximum_dna_length'])
        a0_t = torch.tensor(a0, device=dev)
        a1_t = torch.tensor(a1, device=dev)
        k = torch.arange(tl, device=dev)
        idx = a1_t[:, None] - (tl - 1) + k[None, :]
        valid = idx >= a0_t[:, None]
        win = torch.gather(scaled, 1, idx.clamp(0, scaled.shape[1] - 1))
        win = torch.where(valid, nets.med_mad_normalize(win, valid),
                          PAD_FILLER)
        d = self.demux
        xs = win[..., None]
        seq = torch.cat([nets.lstm(d['bilstm_fwd'], xs),
                         nets.lstm(d['bilstm_bwd'], xs, reverse=True)], -1)
        h = nets.lstm(d['lstm2'], seq, return_sequences=False)
        probs = torch.softmax(nets.dense(d['dense'], h), dim=-1)
        probs = probs.cpu().numpy()
        for i, rec in enumerate(recs):
            rec['demux_probs'] = probs[i]

    def _barcode(self, rec):
        probs = rec['demux_probs']
        bcid = int(np.argmax(probs)) - self.dmx['number_of_decoy_labels']
        score = float(np.max(probs))
        rec['barcode'] = (bcid if bcid >= 0 and
                          score >= self.demux_threshold else None)
        rec['barcode_score'] = (0 if score <= 0.0 else int(
            np.searchsorted(self.calibration, score, side='right')))

    # ------------------------------------------------------------------
    def _polya(self, rec, meta):
        scale, shift = (float(v) for v in rec['scaling'])
        a = scale * float(meta['pa_scale'])
        segs = rec['segments']
        tail = self.seg_names.index('polya-tail')
        rough = segs.get(tail, (segs[self.adapter_idx][1] + 1, None))
        rec['polya'] = self.polya_ref(
            rec['read'].raw_dac, (a, a * float(meta['offset']) + shift),
            meta['sampling_rate'], rough, self.stride)

    def _events(self, rec, rate):
        read = rec['read']
        scale, shift = (float(v) for v in rec['scaling'])
        ev = read.events
        starts = np.asarray(ev['start'], np.int64)
        rec['events'] = {
            'start': starts,
            'end': starts + np.hstack((np.diff(starts), [1])),
            'scaled_mean': np.asarray(ev['mean']) * scale + shift,
            'pos': np.cumsum(ev['move']),
            'p_model_state': np.asarray(ev['p_model_state']),
        }
        # upstream returns early whenever a sequence exists, so the
        # preset's adapter trimming trims nothing
        rec['sequence'] = (read.sequence, read.qstring, 0)

    def _unsplit_windows(self, rec, rate):
        """(rec, lo, hi) event windows after the adapter
        (poreplex/signal_analyzer.py:369-387)."""
        cfg = self.unsplit
        payload_start = (rec['segments'][self.adapter_idx][1] + 1) * \
            self.stride
        rec['payload_start'] = payload_start
        size = int(cfg['window_size'] * rate)
        step = int(cfg['window_step'] * rate)
        starts = rec['events']['start']
        last_end = int(rec['events']['end'][-1])
        rec['windows'] = []
        out = []
        for left in range(payload_start, last_end, step):
            lo = int(np.searchsorted(starts, left, side='left'))
            hi = int(np.searchsorted(starts, left + size, side='right'))
            if hi - lo < 1:
                break
            rec['windows'].append((lo, hi))
            out.append((rec, lo, hi))
        return out

    def _unsplit(self, windows, rate):
        dev = self.device
        width = max(hi - lo for _, lo, hi in windows)
        x = np.zeros((len(windows), width), np.float32)
        lens = np.zeros(len(windows), np.int64)
        for r, (rec, lo, hi) in enumerate(windows):
            x[r, :hi - lo] = rec['events']['scaled_mean'][lo:hi]
            lens[r] = hi - lo
        paths = []
        for lo in range(0, len(windows), 1024):
            paths.append(nets.viterbi(
                torch.tensor(x[lo:lo + 1024], device=dev),
                torch.tensor(lens[lo:lo + 1024], device=dev),
                *self.unsplit_hmm).cpu().numpy())
        paths = np.concatenate(paths)
        runs = {}
        for r, (rec, lo, hi) in enumerate(windows):
            runs.setdefault(id(rec), []).append(
                self._runs(paths[r, :lens[r]]))
        for rec, _, _ in windows:
            if 'failed' not in rec and id(rec) in runs:
                if self._is_unsplit(rec, runs.pop(id(rec)), rate):
                    rec['failed'] = 'unsplit_read'

    def _runs(self, path):
        """(leader_start, first, last) of each adapter run and the chain
        of leader states before it (poreplex/signal_analyzer.py:388-404)."""
        names = self.unsplit_names
        leaderish = {names.index(n) for n in ('adapter', 'leader-high',
                                               'leader-low') if n in names}
        adapter = names.index('adapter')
        trios, leader_start = [], None
        change = np.flatnonzero(np.diff(path)) + 1
        for first, last in zip(np.concatenate([[0], change]),
                               np.concatenate([change - 1, [len(path) - 1]])):
            state = int(path[first])
            if state not in leaderish:
                leader_start = None
                continue
            if leader_start is None:
                leader_start = int(first)
            if state == adapter:
                trios.append((leader_start, int(first), int(last)))
                leader_start = None
        return trios

    def _is_unsplit(self, rec, runs, rate):
        """poreplex/signal_analyzer.py:405-443."""
        cfg = self.unsplit
        _ = lambda name: int(cfg[name] * rate)
        strict_duration = _('strict_duration')
        cutoffs = [(_('loosen_full_length'), _('loosen_dna_length')),
                   (_('strict_full_length'), _('strict_dna_length'))]
        ev = rec['events']
        starts, ends = ev['start'], ev['end']
        payload_start = rec['payload_start']
        excessive = []
        for (lo, hi), wruns in zip(rec['windows'], runs):
            for leader_start, first, last in wruns:
                adapter_end = int(ends[lo + last])
                leader_at = int(starts[lo + leader_start])
                total_cutoff, adapter_cutoff = cutoffs[
                    (leader_at - payload_start) <= strict_duration]
                if (adapter_end - leader_at >= total_cutoff and
                        adapter_end - starts[lo + first] >= adapter_cutoff):
                    excessive.append([leader_at, 1 + adapter_end])
        if not excessive:
            return False
        merged = []
        for begin, end in sorted(excessive):
            if merged and begin <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([begin, end])
        intervals = [[0, payload_start]] + merged + [[np.inf, np.inf]]
        pos, qual = ev['pos'], ev['p_model_state']
        counts = []
        for (_l, left), (right, _r) in zip(intervals, intervals[1:]):
            sel = (starts >= left) & (starts <= right)
            best = {}
            for p, v in zip(pos[sel].tolist(), qual[sel].tolist()):
                best[p] = max(best.get(p, v), v)
            counts.append(sum(v > cfg['basecount_quality_limit']
                              for v in best.values()))
        total = sum(counts[1:])
        return (total > cfg['subread_basecount_limit'] or
                (total + 1) / (counts[0] + 1) >
                cfg['subread_baseratio_limit'])

    # ------------------------------------------------------------------
    def _report(self, rec, meta):
        """(summary row fields past filename and read id, FASTQ record)."""
        if rec['label'] is None:
            return None, None
        read = rec['read']
        seq = rec.get('sequence')
        row = {
            'run_id': read.run_id,
            'channel': meta['channel'],
            'start_time': round(meta['start_time'] / meta['sampling_rate'],
                                3),
            'duration': read.duration,
            'num_events': len(read.events['start']) if seq else 0,
            'sequence_length': len(read.sequence) if seq else 0,
            'mean_qscore': meta['mean_qscore'] if seq else 0,
            'sample_id': meta['sample_id'],
            'status': rec['status'],
            'label': LABEL_NAMES[rec['label']],
        }
        if self.barcoding:
            bc = rec['barcode']
            row['barcode'] = 'undetermined' if bc is None else \
                'BC{}'.format(bc + 1)
            row['barcode_score'] = rec.get('barcode_score', 0) \
                if bc is not None else 0
        if self.polya:
            row['polya_dwell'] = (format(rec['polya']['dwell_time'], '.4f')
                                  if rec['polya'] is not None else '')
        fastq = None
        if seq is not None:
            s, q, trim = seq
            if trim > 0:
                s, q = s[:-trim], q[:-trim]
            fastq = (self.output_name(rec['label'], rec['barcode']), s, q)
        return {k: str(v) for k, v in row.items()}, fastq
