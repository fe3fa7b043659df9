"""The poly(A) analyzer, one read at a time: upstream poreplex's window,
extension and recalibration lattice (poreplex/polya.py:30-187) in
float32, every event that a window holds in its table.

A frozen copy of ``poreplex_torch``'s plain float32 ops (``ops/f32.py``,
``ops/event_detection.py``, ``ops/polya_round.py``), run on the CPU over
one window at a time:

* a window's DAC samples dequantized as the system's lossless 16-bit wire
  does (``lo + q * step`` rounded once), median-filtered;
* scrappie's t-statistic event detection from float32 cumulative sums of
  the mean-centred window, added in XLA:CPU's association, with the dual
  peak detector's state machine on Python floats (its two subtractions
  rounded to float32 as the system's are), every peak found an event
  boundary, as upstream's C detector keeps them;
* tail marking, the best-interval DP (integer scores, first maximum in
  row order), the interval's level, the stdv QC and the anchor
  recalibration, each as the system computes them.
"""

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import medfilt

F32_TINY = float(np.finfo(np.float32).tiny)
F32_MAX = float(np.finfo(np.float32).max)
# window lengths that the samples are padded to: the order in which the
# float32 sums over a window are added
BUCKETS = (8192, 16384, 32768, 131072)
PACK_SAFE_LEN = 5 * 131072
SCAN_BLOCK = 16
SUM_BLOCK = 32


# ---------------------------------------------------------------- float32

def fma(a, b, c):
    """float32 a * b + c rounded once (through float64)."""
    return (a.double() * b.double() + c.double()).float()


def _running(x):
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
        out[..., k] = acc
    return out


def cumsum(x):
    """Inclusive prefix sums of [B, n]: blocks of 16 left to right, the
    block totals scanned the same way, each block offset by the total
    before it."""
    batch, n = x.shape
    if n <= SCAN_BLOCK:
        return _running(x)
    pad = (-n) % SCAN_BLOCK
    inner = _running(F.pad(x, (0, pad)).reshape(batch, -1, SCAN_BLOCK))
    outer = cumsum(inner[..., -1].contiguous())
    before = F.pad(outer[:, :-1], (1, 0))
    return (inner + before[..., None]).reshape(batch, -1)[:, :n]


def rowsum(x):
    """Sums of [B, n]: blocks of 32 left to right, the row padded with
    zeros split evenly before and after, recursively."""
    batch, n = x.shape
    if n > SUM_BLOCK:
        pad = (-n) % SUM_BLOCK
        x = F.pad(x, (pad // 2, pad - pad // 2)).reshape(batch, -1, SUM_BLOCK)
    acc = x.new_zeros(x.shape[:-1])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc if n <= SUM_BLOCK else rowsum(acc)


# ---------------------------------------------------------------- events

def tstat(cs, css, length, w):
    """Windowed t-statistic [1, T] of one window's centred cumulative
    sums; nonzero for w <= i <= L - w."""
    seqlen = cs.shape[1] - 1

    def at_i_minus_w(c):
        head = c[:, :1].expand(1, min(w, seqlen))
        return torch.cat([head, c[:, :max(seqlen - w, 0)]], dim=1)

    def at_i_plus_w(c):
        if w > seqlen:
            return c[:, seqlen:].expand(1, seqlen)
        return torch.cat([c[:, w:seqlen + 1],
                          c[:, seqlen:].expand(1, w - 1)], dim=1)

    recip = torch.tensor(np.float32(1) / np.float32(w))
    sum1 = cs[:, :seqlen] - at_i_minus_w(cs)
    ssq1 = css[:, :seqlen] - at_i_minus_w(css)
    sum2 = at_i_plus_w(cs) - cs[:, :seqlen]
    ssq2 = at_i_plus_w(css) - css[:, :seqlen]
    mean1 = sum1 * recip
    mean2 = sum2 * recip
    var = fma(ssq1, recip, -(mean1 * mean1))
    var = fma(ssq2, recip, var)
    var = fma(-mean2, mean2, var)
    var = torch.clamp(var, min=F32_TINY) * recip
    t = (mean2 - mean1).abs() * (1.0 / var.double().sqrt()).float()
    idx = torch.arange(seqlen)[None, :]
    keep = (idx >= w) & (idx <= length - w) & (length >= 2 * w) & (w >= 2)
    return torch.where(keep, t, 0.0)


def _f32_exceeds(height):
    """d > height after rounding d, a float64 difference of two float32
    values, to float32: a test against the midpoint between height and
    the next float32 above it (a tie rounds to the even one)."""
    h = np.float32(height)
    up = np.nextafter(h, np.float32(np.inf))
    mid = (float(h) + float(up)) / 2
    if np.frombuffer(h.tobytes(), np.uint32)[0] & 1 == 0:
        return lambda d: d > mid
    return lambda d: d >= mid


def _step(state, tval, i, length, threshold, half, exceeds):
    """One frame of one detector (event_detection.c:139-197): (state,
    emitted position or -1, dominating, the peak position after it)."""
    masked_to, pp, pv, valid = state
    skip = masked_to >= i or i >= length
    if pp == -1:
        deeper = tval < pv
        qualify = exceeds(tval - pv)
        new_pv = tval if (deeper or qualify) else pv
        new_pp = i if (not deeper and qualify) else pp
        new_valid = valid
        emitted = -1
        dominating = False
    else:
        higher = tval > pv
        pv2 = tval if higher else pv
        pp2 = i if higher else pp
        valid2 = valid or (exceeds(pv2 - tval) and pv2 > threshold)
        emitted = -1
        if valid2 and i - pp2 > half:
            emitted = pp2
            pp2, pv2, valid2 = -1, tval, False
        new_pp, new_pv, new_valid = pp2, pv2, valid2
        dominating = new_pv > threshold
    if skip:
        return state, -1, False, new_pp
    return (masked_to, new_pp, new_pv, new_valid), emitted, dominating, \
        new_pp


def peaks(t1, t2, length, thr1, thr2, wl1, wl2, peak_height):
    """The dual detector in the system's two passes: the short detector
    over every frame, then the long one, reset and masked wherever the
    short one dominates. Returns the peak positions > 0 in emission
    order, short before long at a frame."""
    exceeds = _f32_exceeds(peak_height)
    t1, t2 = t1.tolist(), t2.tolist()
    state = (0, -1, F32_MAX, False)
    short, dom = [-1] * length, [None] * length
    for i in range(length):
        state, short[i], d, pos = _step(state, t1[i], i, length, thr1,
                                        wl1 // 2, exceeds)
        dom[i] = pos if d else None
    state = (0, -1, F32_MAX, False)
    out = []
    for i in range(length):
        if dom[i] is not None:
            state = (dom[i] + wl1, -1, F32_MAX, False)
        state, emitted, _, _ = _step(state, t2[i], i, length, thr2,
                                     wl2 // 2, exceeds)
        if short[i] > 0:
            out.append(short[i])
        if emitted > 0:
            out.append(emitted)
    return out


def events(sig, length, blen, ed, bf16=False):
    """The event table of one window sig [1, blen] (zero past length),
    one event more than the peaks found: (start [P+1] int, length, mean,
    stdv [P+1] float32 tensors, n_events, cs, css)."""
    valid = torch.arange(blen)[None, :] < length
    xm = torch.where(valid, sig, 0.0)
    center = rowsum(xm)[:, None] / float(max(length, 1))
    xc = torch.where(valid, sig - center, 0.0)
    zero = sig.new_zeros((1, 1))
    cs = torch.cat([zero, cumsum(xc)], dim=1)
    css = torch.cat([zero, cumsum(xc * xc)], dim=1)
    t1 = tstat(cs, css, length, ed['window_length1'])[0]
    t2 = tstat(cs, css, length, ed['window_length2'])[0]
    if bf16:
        t1 = t1.to(torch.bfloat16).to(torch.float32)
        t2 = t2.to(torch.bfloat16).to(torch.float32)
    found = peaks(t1, t2, length, float(ed['threshold1']),
                  float(ed['threshold2']), ed['window_length1'],
                  ed['window_length2'], float(ed['peak_height']))
    n = len(found)
    starts = torch.zeros(n + 1, dtype=torch.int32)
    ends = torch.zeros(n + 1, dtype=torch.int32)
    starts[1:] = torch.tensor(found, dtype=torch.int32)
    ends[:n] = torch.tensor(found, dtype=torch.int32)
    ends[n] = length
    ends = torch.maximum(ends, starts + 1)
    s64, e64 = starts.long()[None], ends.long()[None]
    size = (ends - starts).to(torch.float32)[None]
    mean_c = (cs.gather(1, e64) - cs.gather(1, s64)) / size
    var = fma(-mean_c, mean_c, (css.gather(1, e64) - css.gather(1, s64)) /
              size)
    stdv = torch.sqrt(torch.clamp(var, min=0.0))
    mean = mean_c + center
    if n == 0:
        size[0, 0], mean[0, 0], stdv[0, 0] = 0.0, float('nan'), 0.0
    return starts[None], size, mean, stdv, n + 1, cs, css


# ---------------------------------------------------------------- round

def best_interval(is_polya, length, spike_weight, spike_tolerance):
    """(start, end, score) of the best poly(A) interval over the first
    n events (poreplex/polya.py:156-187): integer column scores truncated
    toward zero, the first maximum in row order; score <= 0 is none."""
    n = len(is_polya)
    if n == 0:
        return 0, 0, 0
    length = np.asarray(length, np.float64)
    v = (is_polya.astype(np.int64) * 2 - 1) * length
    col_match = np.where(v > 0, v, v * spike_weight).astype(np.int64)
    col_spike = np.where(is_polya, 1.0, -length).astype(np.int64)
    pm = np.concatenate([[0], np.cumsum(col_match)])
    matching = pm[None, 1:] - pm[:-1, None]
    pc = np.concatenate([[0], np.cumsum(col_spike)])
    j = np.arange(n)
    last_pos = np.maximum.accumulate(np.where(col_spike > 0, j, -1))
    reset = last_pos[None, :] >= j[:, None]
    since_reset = spike_tolerance + pc[None, 1:] - pc[last_pos + 1][None, :]
    since_start = pc[None, 1:] - pc[:-1, None]
    raw = np.where(reset, since_reset, since_start)
    upper = j[None, :] >= j[:, None]
    dead = np.maximum.accumulate((raw < 0) & upper, axis=1)
    final = np.where(upper & ~dead & (raw > 0), matching, 0)
    start, end = np.unravel_index(final.argmax(), (n, n))
    return int(start), int(end), int(final[start, end])


def sub_range_stdv(starts, size, cs, css, lo, hi):
    seqlen = cs.shape[1] - 1
    b = (starts + torch.trunc(size * lo).to(torch.int32)).clamp(
        0, seqlen).long()
    f = (starts + torch.trunc(size * hi).to(torch.int32)).clamp(
        0, seqlen).long()
    n = (f - b).to(torch.float32)
    mean_c = (cs.gather(1, f) - cs.gather(1, b)) / n
    var = fma(-mean_c, mean_c, (css.gather(1, f) - css.gather(1, b)) / n)
    return torch.where(n > 2, torch.sqrt(torch.clamp(var, min=0.0)),
                       float('nan'))


def decide(starts, size, mean, stdv_sub, n_events, is_p, cfg):
    """One marking's DP outcome as the system's pack head: (valid,
    e_is_last, mean_level, longest_stdv, begin_rel, end_rel, dwell)."""
    width = mean.shape[1]
    isp = is_p[0, :n_events].numpy()
    s, e, v = best_interval(isp, size[0, :n_events].numpy(),
                            float(cfg['spike_weight']),
                            int(cfg['spike_tolerance']))
    ke = torch.arange(width)[None, :]
    in_int = (ke >= s) & (ke <= e)
    w = torch.where(in_int, size, 0.0)
    level = rowsum(torch.where(in_int, mean, 0.0) * w) / rowsum(w)
    li = int(torch.argmax(torch.where(in_int, size, -1.0), dim=1)[0])
    dwell = torch.where(in_int & is_p, size, 0.0).sum(dim=1)
    end_rel = starts[0, e].to(torch.float32) + size[0, e]
    return dict(valid=v > 0, e_is_last=e == n_events - 1,
                mean_level=float(level[0]),
                longest_stdv=float(stdv_sub[0, li]),
                begin_rel=int(starts[0, s]), end_rel=int(end_rel),
                dwell=int(dwell[0]))


class PolyaReference:

    def __init__(self, config, precision='float32'):
        """``precision='bfloat16'`` rounds the window's samples and its
        t-statistics to bfloat16: the output check's control."""
        self.cfg = config
        self.bf16 = precision == 'bfloat16'
        for name in ('refinement_expansion', 'openend_expansion',
                     'maximum_openend_extension', 'median_pre_filter',
                     'polya_stdv_max', 'polya_mean_dist',
                     'recalibrate_shifted_signal'):
            setattr(self, name, config[name])
        loc, scale = config['polya_mean_dist']
        self.cutoff = (loc - scale * config['polya_mean_z_cutoff'],
                       loc + scale * config['polya_mean_z_cutoff'])
        self.trigger = config['polya_mean_trigger_recalibration'] * scale
        self.recal_zr = float(scale * config['polya_mean_z_cutoff'])
        self.rounds = 0

    @torch.inference_mode()
    def __call__(self, raw_dac, affine, sampling_rate, rough_range, stride):
        """{'begin', 'end', 'dwell_time'} of one read's tail, or None.
        ``affine`` (a, b) maps the DAC samples onto the scaled signal."""
        self.result = None
        task = dict(rough_begin=rough_range[0], rough_end=rough_range[1],
                    orig_end_none=rough_range[1] is None, polya_range=None,
                    depth=0, rounds=1)
        while task is not None:
            self.rounds += 1
            row = self._round(task, raw_dac, affine, stride)
            task = self._replay(task, row, sampling_rate, stride)
            if task is not None and \
                    task['rounds'] > self.maximum_openend_extension:
                task = None
        return self.result

    def _round(self, t, raw, affine, stride):
        meu = self.openend_expansion // stride
        if t['rough_end'] is None or \
                t['rough_end'] - t['rough_begin'] < meu:
            t['rough_end'] = t['rough_begin'] + meu
        begin = max(0, t['rough_begin'] * stride - self.refinement_expansion)
        end = min(len(raw), (t['rough_end'] + 1) * stride +
                  self.refinement_expansion, begin + PACK_SAFE_LEN)
        t.update(insp_begin=begin, insp_end=end, full_length=len(raw),
                 adapter_end=t['rough_begin'] * stride - begin)
        window = raw[begin:end]
        length = len(window)
        # the lossless wire: q = dac - min, dequantized lo + q * step
        a, b = np.float32(affine[0]), np.float32(affine[1])
        low = int(window.min()) if length else 0
        qlo = a * np.float32(low) + b
        q = window.astype(np.int64) - low
        sig = (q.astype(np.float64) * np.float64(a) +
               np.float64(qlo)).astype(np.float32)
        if self.median_pre_filter > 1:
            sig = medfilt(sig, self.median_pre_filter).astype(np.float32)
        blen = _bucket_len(length)
        padded = torch.zeros((1, blen), dtype=torch.float32)
        padded[0, :length] = torch.from_numpy(sig)
        if self.bf16:
            padded = padded.to(torch.bfloat16).to(torch.float32)
        starts, size, mean, stdv, n_events, cs, css = events(
            padded, length, blen, self.cfg['event_detection'], self.bf16)
        width = mean.shape[1]
        live = torch.arange(width)[None, :] < n_events
        rng = t['polya_range'] or self.cutoff
        lo, hi = np.float32(rng[0]), np.float32(rng[1])
        is_p1 = (mean >= float(lo)) & (mean <= float(hi)) & live
        sub = sub_range_stdv(starts, size, cs, css,
                             float(self.cfg['polya_stdv_range'][0]),
                             float(self.cfg['polya_stdv_range'][1]))
        rc = self.recalibrate_shifted_signal
        adapter_end = t['adapter_end']
        end_h = starts + size.to(torch.int32)
        sel = ((starts <= adapter_end + int(rc['max_dist_from_adapter'])) &
               (end_h > adapter_end) & (stdv < float(rc['max_stdv'])) & live)
        aw = torch.where(sel, size, 0.0)
        anchor = rowsum(torch.where(sel, mean, 0.0) * aw) / rowsum(aw)
        recal_lo = anchor - self.recal_zr
        recal_hi = anchor + self.recal_zr
        is_p2 = (mean >= recal_lo[:, None]) & (mean <= recal_hi[:, None]) & \
            live
        return dict(
            a=decide(starts, size, mean, sub, n_events, is_p1, self.cfg),
            b=decide(starts, size, mean, sub, n_events, is_p2, self.cfg),
            anchor_any=bool(sel.any()), recal_lo=float(recal_lo[0]),
            recal_hi=float(recal_hi[0]),
            marked_len=float(torch.where(is_p2, size, 0.0).sum()))

    def _follow(self, t, rough_end, depth):
        return dict(rough_begin=t['rough_begin'], rough_end=rough_end,
                    orig_end_none=False, polya_range=t['polya_range'],
                    depth=depth, rounds=t['rounds'] + 1)

    def _replay(self, t, row, rate, stride):
        """The decision lattice on one round's outcome; the next round's
        task (an open-end extension) or None."""
        range_was_set = t['polya_range'] is not None
        if t['orig_end_none']:
            outcome = self._recal(t, row, rate)
        else:
            outcome = self._outcome(t, row['a'], range_was_set, rate)
            if outcome == 'recalibrate':
                outcome = self._recal(t, row, rate)
        if outcome != 'extend':
            return None
        return self._follow(t, t['rough_end'] +
                            self.openend_expansion // stride, t['depth'] + 1)

    def _recal(self, t, row, rate):
        if not row['anchor_any']:
            return 'done'
        if row['marked_len'] < self.recalibrate_shifted_signal['min_length']:
            return 'done'
        t['polya_range'] = (row['recal_lo'], row['recal_hi'])
        return self._outcome(t, row['b'], True, rate)

    def _outcome(self, t, pack, range_is_set, rate):
        if (pack['valid'] and pack['e_is_last'] and
                t['insp_end'] < t['full_length'] and
                t['depth'] < self.maximum_openend_extension):
            return 'extend'
        if not pack['valid'] or (
                not range_is_set and
                abs(pack['mean_level'] - self.polya_mean_dist[0]) >
                self.trigger):
            return 'recalibrate' if not range_is_set else 'done'
        if pack['longest_stdv'] < self.polya_stdv_max:
            self.result = {
                'begin': pack['begin_rel'] + t['insp_begin'],
                'end': pack['end_rel'] + t['insp_begin'],
                'dwell_time': pack['dwell'] / rate}
            return 'done'
        if not range_is_set:
            return 'recalibrate'
        return 'done'


def _bucket_len(n):
    for b in BUCKETS:
        if n <= b:
            return b
    return ((n + BUCKETS[-1] - 1) // BUCKETS[-1]) * BUCKETS[-1]
