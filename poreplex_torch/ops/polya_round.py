"""One poly(A) round over a batch of signal windows, with the semantics of
poreplex-tpu's ``ops/polya_round.py``: median pre-filter, event detection,
tail marking, the interval DP and everything the host's decision lattice
reads from the event table, returned as a row of scalars per window (and
a spike table per decision pack):

* pack A: the DP outcome with the window's current poly(A) mean range
  (its recalibrated range, or the preset's z-range);
* pack B: the DP outcome with the range recalibrated from the events at
  the adapter end, which the host applies only when its control flow
  recalibrates.

The peak detector and the DP run through their kernel wrappers; the rest
is plain PyTorch, with XLA:CPU's float32 association where the JAX op's
results depend on it (``ops.f32``).

On a card a round is some 1,700 small ops, and dispatching them costs the
host far more than the device's work. ``RoundGraph`` captures the round
once per (device, window bucket, row capacity, parameters) as a CUDA graph
and replays it: a launch's rows are padded with empty windows up to the
capacity. Every op of the round is row-independent (scans and sums along
a row, the median filter, the peak lanes, the DP rows), so the padding
cannot change a real row's bits.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from .event_detection import detect_events_core
from .f32 import fma, rowsum

# decision-pack head: valid, s, e, e_is_last, mean_level, longest_stdv,
# begin_rel, end_rel, dwell, spike_count
PACK_HEAD = 10
# spike row: length, code (0 no neighbour / 2 previous only / 3 both),
# mean_prev, mean_self, mean_next
SPIKE_COLS = 5
# n_events, anchor_any, anchor_mean, recal_lo, recal_hi, recal_marked_len,
# peaks_truncated
GLOBAL_COLS = 7
HEAD_COLS = 2 * PACK_HEAD + GLOBAL_COLS
# window table: offset, length, adapter_end, rng_lo, rng_hi, dequant_lo,
# dequant_step
META_COLS = 7


def medfilt(sig, k):
    """Zero-padded median filter over the time axis of [B, T]
    (scipy.signal.medfilt semantics)."""
    if k <= 1:
        return sig
    h = k // 2
    return F.pad(sig, (h, h)).unfold(1, k, 1).median(dim=-1).values


def window_signal(stream, meta, blen, median_pre_filter):
    """The median-filtered, dequantized windows [R, blen] of a u16 stream
    (carried as int32) and their lengths [R]. Dequantization is
    lo + q * step rounded once, as XLA:CPU contracts it."""
    offset = meta[:, 0].to(torch.int64)
    lengths = meta[:, 1].to(torch.int32)
    j = torch.arange(blen, device=stream.device)[None, :]
    idx = (offset[:, None] + j).clamp(0, stream.shape[0] - 1)
    q = stream[idx].to(torch.float32)
    sig = torch.where(j < lengths[:, None],
                      fma(q, meta[:, 6:7], meta[:, 5:6]), 0.0)
    return medfilt(sig, median_pre_filter), lengths


def _sub_range_stdv(starts, length, cs, css, stdv_lo, stdv_hi):
    """Stdv of each event's [start + trunc(len * lo), start + trunc(len *
    hi)) sub-slice from the centred cumulative sums; NaN below 3 samples,
    so a comparison with the stdv limit is False."""
    seqlen = cs.shape[1] - 1
    b = (starts + torch.trunc(length * stdv_lo).to(torch.int32)).clamp(
        0, seqlen).long()
    f = (starts + torch.trunc(length * stdv_hi).to(torch.int32)).clamp(
        0, seqlen).long()
    n = (f - b).to(torch.float32)
    mean_c = (cs.gather(1, f) - cs.gather(1, b)) / n
    var = fma(-mean_c, mean_c, (css.gather(1, f) - css.gather(1, b)) / n)
    return torch.where(n > 2, torch.sqrt(torch.clamp(var, min=0.0)),
                       float('nan'))


def _decide(starts, length, mean, sub_stdv, n_events, is_p, s, e, v,
            max_spikes):
    """One marking + DP outcome as a pack head [R, PACK_HEAD] and the
    interval's first max_spikes non-poly(A) events [R, max_spikes, 5]."""
    rows, p1 = mean.shape
    dev = mean.device
    ke = torch.arange(p1, device=dev)[None, :]
    s64, e64 = s.long()[:, None], e.long()[:, None]
    in_int = (ke >= s64) & (ke <= e64)

    w = torch.where(in_int, length, 0.0)
    mean_level = rowsum(torch.where(in_int, mean, 0.0) * w) / rowsum(w)
    e_is_last = (e == n_events - 1).to(torch.float32)
    # longest event of the interval, the first on ties
    li = torch.argmax(torch.where(in_int, length, -1.0), dim=1)
    longest_stdv = sub_stdv.gather(1, li[:, None])[:, 0]
    begin_rel = starts.gather(1, s64)[:, 0].to(torch.float32)
    end_rel = (starts.gather(1, e64)[:, 0].to(torch.float32) +
               length.gather(1, e64)[:, 0])
    dwell = torch.where(in_int & is_p, length, 0.0).sum(dim=1)

    spk = in_int & ~is_p
    spike_count = spk.sum(dim=1, dtype=torch.int32)
    running = torch.cumsum(spk.to(torch.int32), dim=1, dtype=torch.int32)
    ks = torch.arange(1, max_spikes + 1, dtype=torch.int32, device=dev)
    pos = torch.searchsorted(running, ks.expand(rows, max_spikes)
                             .contiguous()).clamp(max=p1 - 1)
    have = ks[None, :] <= spike_count[:, None]
    has_nb = pos > s64
    nxt_ok = pos + 1 <= e64
    code = torch.where(has_nb, torch.where(nxt_ok, 3.0, 2.0), 0.0)
    spikes = torch.stack([
        length.gather(1, pos), torch.where(have, code, 0.0),
        mean.gather(1, (pos - 1).clamp(min=0)), mean.gather(1, pos),
        mean.gather(1, (pos + 1).clamp(max=p1 - 1))], dim=2)

    head = torch.stack([
        (v > 0).to(torch.float32), s.to(torch.float32), e.to(torch.float32),
        e_is_last, mean_level, longest_stdv, begin_rel, end_rel, dwell,
        spike_count.to(torch.float32)], dim=1)
    return head, spikes


def polya_round_core(stream, meta, *, blen, window_length1, window_length2,
                     threshold1, threshold2, peak_height, max_peaks,
                     spike_weight, spike_tolerance, max_spikes,
                     median_pre_filter, stdv_lo, stdv_hi, recal_max_dist,
                     recal_max_stdv, recal_zr):
    """stream: the token-packed u16 window samples, as int32 [FLAT];
    meta: [R, META_COLS] float32 (integer fields exact below 2**24).
    Returns (heads [R, HEAD_COLS], spikes [2R, max_spikes, SPIKE_COLS]):
    the spike tables of all A packs, then of all B packs."""
    from ..kernels import polya_dp as dp_kernel
    sig, lengths = window_signal(stream, meta, blen, median_pre_filter)
    adapter_end = meta[:, 2].to(torch.int32)[:, None]
    rng_lo, rng_hi = meta[:, 3:4], meta[:, 4:5]

    ev = detect_events_core(
        sig, lengths, window_length1=window_length1,
        window_length2=window_length2, threshold1=threshold1,
        threshold2=threshold2, peak_height=peak_height, max_peaks=max_peaks,
        return_cumsums=True)
    starts, length, mean = ev['start'], ev['length'], ev['mean']
    n_events = ev['n_events']
    rows, p1 = mean.shape
    valid_ev = (torch.arange(p1, device=mean.device)[None, :] <
                n_events[:, None])
    sub_stdv = _sub_range_stdv(starts, length, ev['cs'], ev['css'],
                               stdv_lo, stdv_hi)

    # primary marking with the window's range (NaN compares False)
    is_p1 = (mean >= rng_lo) & (mean <= rng_hi) & valid_ev

    # anchor recalibration (poreplex/polya.py:127-148): low-stdv events
    # overlapping the adapter end define a shifted poly(A) level
    end_h = starts + length.to(torch.int32)
    sel = ((starts <= adapter_end + recal_max_dist) &
           (end_h > adapter_end) & (ev['stdv'] < recal_max_stdv) & valid_ev)
    anchor_any = sel.any(dim=1)
    aw = torch.where(sel, length, 0.0)
    anchor_mean = rowsum(torch.where(sel, mean, 0.0) * aw) / rowsum(aw)
    recal_lo = anchor_mean - recal_zr
    recal_hi = anchor_mean + recal_zr
    is_p2 = ((mean >= recal_lo[:, None]) & (mean <= recal_hi[:, None]) &
             valid_ev)
    marked_len = torch.where(is_p2, length, 0.0).sum(dim=1)

    # both DPs in one launch: A rows, then B rows
    s_all, e_all, v_all = dp_kernel.dp(is_p1, is_p2, length, n_events,
                                       spike_weight, spike_tolerance)
    head_a, spk_a = _decide(starts, length, mean, sub_stdv, n_events, is_p1,
                            s_all[:rows], e_all[:rows], v_all[:rows],
                            max_spikes)
    head_b, spk_b = _decide(starts, length, mean, sub_stdv, n_events, is_p2,
                            s_all[rows:], e_all[rows:], v_all[rows:],
                            max_spikes)
    tail = torch.stack([
        n_events.to(torch.float32), anchor_any.to(torch.float32),
        anchor_mean, recal_lo, recal_hi, marked_len,
        ev['peaks_truncated'].to(torch.float32)], dim=1)
    return (torch.cat([head_a, head_b, tail], dim=1),
            torch.cat([spk_a, spk_b]))


@torch.inference_mode()
def polya_round(stream, meta, **params):
    return polya_round_core(stream, meta, **params)


def pad_rows(meta, capacity):
    """The [R, META_COLS] window table with all-zero rows (empty windows)
    up to ``capacity`` rows."""
    padded = np.zeros((capacity, META_COLS), np.float32)
    padded[:len(meta)] = meta
    return padded


def real_rows(heads, spikes, rows):
    """The first ``rows`` windows' outputs of a round over more rows, as a
    round over those windows alone returns them: (heads [rows, HEAD_COLS],
    spikes [2 rows, ...]), new tensors."""
    capacity = heads.shape[0]
    return heads[:rows].clone(), torch.cat([spikes[:rows],
                                            spikes[capacity:capacity + rows]])


class RoundGraph:
    """``polya_round_core`` over ``capacity`` rows of bucket ``blen`` on one
    card, replayed from a CUDA graph. The graph owns its inputs, the u16
    wire (as int16, widened inside the graph) and the window table, and its
    outputs. A call writes the inputs, replays and clones the real rows'
    outputs, all on the card's current stream, so the graphs of a card can
    share one memory pool. The first call runs the round eagerly on a side
    stream, its results serving that call, and then captures."""

    def __init__(self, device, blen, capacity, params):
        self.device, self.blen, self.capacity = device, blen, capacity
        self.params = params
        self.wire = torch.zeros(capacity * blen + 1, dtype=torch.int16,
                                device=device)
        self.meta = torch.zeros((capacity, META_COLS), dtype=torch.float32,
                                device=device)
        self.graph = self.outputs = self.launches = None

    def _round(self):
        return polya_round_core(self.wire.to(torch.int32) & 0xFFFF,
                                self.meta, blen=self.blen, **self.params)

    @torch.inference_mode()
    def __call__(self, wire, meta):
        """wire: a launch's u16 windows, concatenated (at most capacity x
        blen samples); meta: [R, META_COLS] (R <= capacity), offsets into
        wire. Returns (heads [R, HEAD_COLS], spikes [2R, max_spikes,
        SPIKE_COLS]) on the card, and whether this call captured. The host
        arrays may be reused once it returns: a copy from pageable memory
        is staged before the copy call returns."""
        rows = len(meta)
        with torch.cuda.device(self.device):
            self.wire[:len(wire)].copy_(
                torch.from_numpy(wire.view(np.int16)), non_blocking=True)
            self.meta.copy_(torch.from_numpy(pad_rows(meta, self.capacity)),
                            non_blocking=True)
            if self.graph is not None:
                self.graph.replay()
                kernels.add_counts(self.launches)
                return real_rows(*self.outputs, rows) + (False,)
            return self._capture(rows) + (True,)

    def _capture(self, rows):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            eager = real_rows(*self._round(), rows)
            before = kernels.counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=_pool(self.device),
                                capture_error_mode='thread_local')
            self.outputs = self._round()
            graph.capture_end()
            self.launches = kernels.take_counts(before)
        current.wait_stream(side)
        for t in eager:
            t.record_stream(current)
        self.graph = graph
        return eager


# captured rounds by graph_key, and each card's memory pool, which all of
# its graphs share: a process keeps them, so sessions one after another
# replay the same graphs
_GRAPHS = {}
_POOLS = {}


def _pool(device):
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return _POOLS[device]


def graph_key(device, blen, capacity, params):
    """A captured round's key: its card, shape and every parameter baked
    into the capture, so another preset never replays it."""
    return (torch.device(device), blen, capacity,
            tuple(sorted(params.items())))


def round_graph(device, blen, capacity, **params):
    """The RoundGraph of ``polya_round_core(..., blen=blen, **params)`` over
    ``capacity`` rows on ``device``, made at first use."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    key = graph_key(device, blen, capacity, params)
    if key not in _GRAPHS:
        _GRAPHS[key] = RoundGraph(device, blen, capacity, params)
    return _GRAPHS[key]


def unpack_rows(heads, spikes, max_spikes):
    """RoundRows of a round's downloaded (heads [R, HEAD_COLS], spikes
    [2R, max_spikes, 5]) numpy arrays."""
    rows = heads.shape[0]
    return [RoundRow(_PackView(heads[i, :PACK_HEAD], spikes[i], max_spikes),
                     _PackView(heads[i, PACK_HEAD:2 * PACK_HEAD],
                               spikes[rows + i], max_spikes),
                     heads[i, 2 * PACK_HEAD:])
            for i in range(rows)]


class RoundRow:
    """Decoded view of one window's round outputs."""

    __slots__ = ('a', 'b', 'n_events', 'anchor_any', 'anchor_mean',
                 'recal_lo', 'recal_hi', 'recal_marked_len',
                 'peaks_truncated', 'blen')

    def __init__(self, a, b, tail):
        self.a = a
        self.b = b
        self.n_events = int(tail[0])
        self.anchor_any = tail[1] > 0
        self.anchor_mean = float(tail[2])
        self.recal_lo = float(tail[3])
        self.recal_hi = float(tail[4])
        self.recal_marked_len = float(tail[5])
        self.peaks_truncated = tail[6] > 0
        self.blen = 0       # window bucket; set by the collecting caller


class _PackView:
    __slots__ = ('valid', 's', 'e', 'e_is_last', 'mean_level',
                 'longest_stdv', 'begin_rel', 'end_rel', 'dwell',
                 'spike_count', '_spk')

    def __init__(self, seg, spk, max_spikes):
        self.valid = seg[0] > 0
        self.s = int(seg[1])
        self.e = int(seg[2])
        self.e_is_last = seg[3] > 0
        self.mean_level = float(seg[4])
        self.longest_stdv = float(seg[5])
        self.begin_rel = int(seg[6])
        self.end_rel = int(seg[7])
        self.dwell = int(seg[8])
        self.spike_count = int(seg[9])
        self._spk = spk[:min(self.spike_count, max_spikes)]

    def spikes(self):
        """The spike rows as the reference's tuples (poreplex/polya.py
        :110-114); complete only when spike_count <= max_spikes (the
        caller recomputes them otherwise)."""
        out = []
        for row in self._spk:
            code = int(row[1])
            if code == 0:
                out.append((float(row[0]),))
            elif code == 2:
                out.append((float(row[0]), float(row[2]), float(row[3])))
            else:
                out.append((float(row[0]), float(row[2]), float(row[3]),
                            float(row[4])))
        return out

