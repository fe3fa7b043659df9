"""Batched scrappie event detection in PyTorch, with the semantics of
poreplex-tpu's ``ops/event_detection.py``:

* windowed two-sample t-statistics from cumulative sums of the per-lane
  mean-centred signal, the sums added in the JAX package's order
  (``ops.f32``) so both devices and the JAX package share their bits;
* the dual short/long peak-detector state machine: ``detect_peaks`` is its
  plain version, two loops over time on [B] tensors (the short detector,
  then the long one from its dominating stream, as the CUDA kernel in
  ``kernels/event_detection.py`` splits them) that the kernel is held
  against;
* peak compaction by binary search on the running count, and per-event
  mean and stdv from the cumulative sums.
"""

import numpy as np
import torch

from .f32 import cumsum, fma, rowsum

F32_TINY = float(np.finfo(np.float32).tiny)
F32_MAX = float(np.finfo(np.float32).max)


def _centered_cumsums(x, lengths):
    """(center [B, 1], cs [B, T+1], css [B, T+1]): exclusive cumulative
    sums of the masked, mean-centred signal and of its square."""
    batch, seqlen = x.shape
    valid = torch.arange(seqlen, device=x.device)[None, :] < lengths[:, None]
    xm = torch.where(valid, x, 0.0)
    center = (rowsum(xm)[:, None] /
              torch.clamp(lengths[:, None], min=1).to(torch.float32))
    xc = torch.where(valid, x - center, 0.0)
    zeros = x.new_zeros((batch, 1))
    cs = torch.cat([zeros, cumsum(xc)], dim=1)
    css = torch.cat([zeros, cumsum(xc * xc)], dim=1)
    return center, cs, css


def compute_tstat(cs, css, lengths, w):
    """Windowed t-statistic [B, T], nonzero only for w <= i <= L - w and
    zero when L < 2w or w < 2. Division by the window is a multiply by its
    float32 reciprocal and the variance sum contracts into fused
    multiply-adds, as XLA:CPU compiles the JAX op; its reciprocal square
    root is taken correctly rounded here, where XLA:CPU's may differ by an
    ulp."""
    batch, seqlen = cs.shape[0], cs.shape[1] - 1

    def at_i_minus_w(c):                       # c[:, max(i - w, 0)]
        head = c[:, :1].expand(batch, min(w, seqlen))
        return torch.cat([head, c[:, :max(seqlen - w, 0)]], dim=1)

    def at_i_plus_w(c):                        # c[:, min(i + w, T)]
        if w > seqlen:
            return c[:, seqlen:].expand(batch, seqlen)
        return torch.cat([c[:, w:seqlen + 1],
                          c[:, seqlen:].expand(batch, w - 1)], dim=1)

    # filled on the device, not copied from the host, so a CUDA graph can
    # capture it
    recip = torch.full((), float(np.float32(1) / np.float32(w)),
                       dtype=torch.float32, device=cs.device)
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
    tstat = (mean2 - mean1).abs() * (1.0 / var.double().sqrt()).float()

    idx = torch.arange(seqlen, device=cs.device)[None, :]
    L = lengths[:, None]
    in_range = (idx >= w) & (idx <= L - w)
    degenerate = (L < 2 * w) | (w < 2)
    return torch.where(in_range & ~degenerate, tstat, 0.0)


def _detector_step(state, tval, i, lengths, threshold, window_length,
                   peak_height):
    """One frame of one detector over [B] lanes (event_detection.c
    :139-197). state: [masked_to, peak_pos, peak_value, valid]. Returns
    (state, emitted [B] with -1 for none, dominating [B], dominating
    position [B])."""
    masked_to, peak_pos, peak_value, valid = state
    skip = (masked_to >= i) | (i >= lengths)
    not_in_peak = peak_pos == -1
    # CASE 1: no maximum recorded yet
    deeper = tval < peak_value
    qualify = (tval - peak_value) > peak_height
    pv1 = torch.where(deeper | qualify, tval, peak_value)
    pp1 = torch.where(~deeper & qualify, i, peak_pos)
    # CASE 2: inside an existing peak
    higher = tval > peak_value
    pv2 = torch.where(higher, tval, peak_value)
    pp2 = torch.where(higher, i, peak_pos)
    valid2 = valid | (((pv2 - tval) > peak_height) & (pv2 > threshold))
    fire = valid2 & ((i - pp2) > window_length // 2)
    emitted = torch.where(fire, pp2, -1)
    pp2 = torch.where(fire, -1, pp2)
    pv2 = torch.where(fire, tval, pv2)
    valid2 = valid2 & ~fire

    new_pp = torch.where(not_in_peak, pp1, pp2)
    new_pv = torch.where(not_in_peak, pv1, pv2)
    new_valid = torch.where(not_in_peak, valid, valid2)
    state = (masked_to, torch.where(skip, peak_pos, new_pp),
             torch.where(skip, peak_value, new_pv),
             torch.where(skip, valid, new_valid))
    emitted = torch.where(skip | not_in_peak, -1, emitted)
    dominating = ~skip & ~not_in_peak & (new_pv > threshold)
    return state, emitted, dominating, new_pp


def _fresh(batch, dev):
    return (torch.zeros(batch, dtype=torch.int32, device=dev),
            torch.full((batch,), -1, dtype=torch.int32, device=dev),
            torch.full((batch,), F32_MAX, dtype=torch.float32, device=dev),
            torch.zeros(batch, dtype=torch.bool, device=dev))


def short_pass(tstat1, lengths, threshold1, window_length1, peak_height,
               steps):
    """The short detector alone over frames [0, steps): (peaks_short,
    dominating, dom_pos), each [B, T]. It reads nothing of the long
    detector."""
    batch, seqlen = tstat1.shape
    em_s = torch.full((batch, seqlen), -1, dtype=torch.int32,
                      device=tstat1.device)
    dom = torch.zeros((batch, seqlen), dtype=torch.bool, device=tstat1.device)
    dom_pos = torch.full_like(em_s, -1)
    state = _fresh(batch, tstat1.device)
    for i in range(steps):
        state, em_s[:, i], dom[:, i], dom_pos[:, i] = _detector_step(
            state, tstat1[:, i], i, lengths, threshold1, window_length1,
            peak_height)
    return em_s, dom, dom_pos


def long_pass(tstat2, lengths, dom, dom_pos, threshold2, window_length1,
              window_length2, peak_height, steps):
    """The long detector over frames [0, steps), given the short one's
    dominating flag and position of each frame: while the short detector
    dominates it resets the long one and masks it to dom_pos +
    window_length1, before the long one's own step (event_detection.c
    :169-179). Returns peaks_long [B, T]."""
    batch, seqlen = tstat2.shape
    em_l = torch.full((batch, seqlen), -1, dtype=torch.int32,
                      device=tstat2.device)
    state = _fresh(batch, tstat2.device)
    for i in range(steps):
        masked_to, peak_pos, peak_value, valid = state
        d = dom[:, i]
        state = (torch.where(d, dom_pos[:, i] + window_length1, masked_to),
                 torch.where(d, -1, peak_pos),
                 torch.where(d, F32_MAX, peak_value),
                 valid & ~d)
        state, em_l[:, i], _, _ = _detector_step(
            state, tstat2[:, i], i, lengths, threshold2, window_length2,
            peak_height)
    return em_l


def detect_peaks(tstat1, tstat2, lengths, threshold1, threshold2,
                 window_length1, window_length2, peak_height):
    """The dual detector: (peaks_short [B, T], peaks_long [B, T]) int32,
    the emitted peak position or -1 at each frame, in the kernel's two
    passes: the short detector over every frame, then the long one from
    the short one's dominating stream. Both loops end at the longest
    length: frames past a lane's length emit -1."""
    lengths = lengths.to(torch.int32)
    batch, seqlen = tstat1.shape
    steps = min(seqlen, int(lengths.max())) if batch else 0
    em_s, dom, dom_pos = short_pass(tstat1, lengths, threshold1,
                                    window_length1, peak_height, steps)
    em_l = long_pass(tstat2, lengths, dom, dom_pos, threshold2,
                     window_length1, window_length2, peak_height, steps)
    return em_s, em_l


def compact_peaks(peaks_short, peaks_long, max_peaks):
    """Both emission streams merged in append order (short before long at
    a frame), positions > 0 only, compacted to [B, max_peaks] with -1
    padding. Returns (bounds, count, true_count)."""
    batch, seqlen = peaks_short.shape
    max_peaks = min(max_peaks, 2 * seqlen)
    inter = torch.stack([peaks_short, peaks_long], dim=2).reshape(
        batch, 2 * seqlen)
    running = torch.cumsum((inter > 0).to(torch.int32), dim=1,
                           dtype=torch.int32)
    true_count = running[:, -1]
    count = torch.clamp(true_count, max=max_peaks)
    ks = torch.arange(1, max_peaks + 1, dtype=torch.int32,
                      device=inter.device).expand(batch, max_peaks)
    idx = torch.searchsorted(running, ks.contiguous())
    gathered = torch.gather(inter, 1, idx.clamp(max=2 * seqlen - 1))
    in_range = (torch.arange(max_peaks, device=inter.device)[None, :] <
                count[:, None])
    return torch.where(in_range, gathered, -1), count, true_count


def event_stats(boundaries, n_bounds, center, cs, css, lengths):
    """Events [0, b0), [b0, b1), ..., [b_last, L) (event_detection.c
    :238-271): start [B, P+1] int32, length / mean / stdv [B, P+1] float32
    and n_events [B]. A lane without peaks keeps the C code's degenerate
    single event [0, 0): length 0, mean NaN, stdv 0."""
    batch, max_peaks = boundaries.shape
    dev = boundaries.device
    zero = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    starts = torch.cat([zero, boundaries], dim=1)
    ends = torch.cat([boundaries, zero], dim=1)
    ev_idx = torch.arange(max_peaks + 1, device=dev)[None, :]
    n_events = n_bounds + 1
    ends = torch.where(ev_idx == (n_events[:, None] - 1),
                       lengths[:, None].to(torch.int32), ends)
    valid_ev = ev_idx < n_events[:, None]
    starts = torch.where(valid_ev, starts, 0)
    ends = torch.where(valid_ev, torch.maximum(ends, starts + 1), starts + 1)

    s64, e64 = starts.long(), ends.long()
    length = (ends - starts).to(torch.float32)
    mean_c = (cs.gather(1, e64) - cs.gather(1, s64)) / length
    var = fma(-mean_c, mean_c,
              (css.gather(1, e64) - css.gather(1, s64)) / length)
    stdv = torch.sqrt(torch.clamp(var, min=0.0))
    mean = mean_c + center

    degenerate = (n_bounds == 0)[:, None] & (ev_idx == 0)
    length = torch.where(degenerate, 0.0, length)
    mean = torch.where(degenerate, float('nan'), mean)
    stdv = torch.where(degenerate, 0.0, stdv)
    return starts, length, mean, stdv, n_events


def detect_events_core(signal, lengths, window_length1=7, window_length2=20,
                       threshold1=3.0, threshold2=8.0, peak_height=4.0,
                       max_peaks=1023, return_cumsums=False):
    """Event detection of a padded [B, T] float32 batch. The peak
    detector runs through its kernel wrapper: the CUDA kernel for CUDA
    tensors, ``detect_peaks`` for CPU ones. ``peaks_truncated`` marks lanes
    with more peaks than ``max_peaks``, whose event table was cut."""
    from ..kernels import event_detection as peak_kernel
    lengths = lengths.to(torch.int32)
    center, cs, css = _centered_cumsums(signal, lengths)
    t1 = compute_tstat(cs, css, lengths, window_length1)
    t2 = compute_tstat(cs, css, lengths, window_length2)
    ps, pl = peak_kernel.detect_peaks(t1, t2, lengths, threshold1,
                                      threshold2, window_length1,
                                      window_length2, peak_height)
    bounds, n_bounds, true_peaks = compact_peaks(ps, pl, max_peaks)
    starts, length, mean, stdv, n_events = event_stats(
        bounds, n_bounds, center, cs, css, lengths)
    out = {'start': starts, 'length': length, 'mean': mean, 'stdv': stdv,
           'n_events': n_events, 'peaks_truncated': true_peaks > max_peaks}
    if return_cumsums:
        out.update({'center': center, 'cs': cs, 'css': css})
    return out


@torch.inference_mode()
def detect_events(signal, lengths, **params):
    """``detect_events_core`` without the cumulative sums."""
    return detect_events_core(signal, lengths, **params)
