"""Synthetic direct-RNA reads: a frozen, vectorised copy of
``poreplex_torch.simulate.simulate_read``.

A read's signal follows the segmentation HMM's states (pre-leader, leader,
adapter, poly(A), transcript) in picoamperes, digitised to 16-bit DAC
values, with an albacore-style basecall of its transcript region. Random
numbers come only from the ``numpy.random.Generator`` passed in, so a seed
gives the same reads. The per-event means and the k-mer column of the
original's Python loops are left out or computed from cumulative sums:
the pipeline reads ``mean``, ``start``, ``move`` and ``p_model_state``.
"""

import numpy as np

DIGITISATION = 8192.0
RANGE = 1169.0
OFFSET = 3.0
SAMPLING_RATE = 3012.0
PA_SCALE = RANGE / DIGITISATION

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

BASES = np.frombuffer(b'ACGT', np.uint8)
MEAN_QSCORE = 9.5
# raw samples a basecalled event spans, and a transcript level's duration
EVENT_SAMPLES = 35


class Read:
    """One simulated read: its DAC signal, metadata and basecall."""

    __slots__ = ('raw_dac', 'run_id', 'sequence', 'qstring', 'events',
                 'polya_len', 'transcript_len', 'two_molecules', 'barcode')

    def __init__(self, **fields):
        for name, value in fields.items():
            setattr(self, name, value)

    @property
    def duration(self):
        return len(self.raw_dac)


def _to_dac(pa):
    dac = pa / (RANGE / DIGITISATION) - OFFSET
    return np.clip(np.round(dac), -32768, 32767).astype(np.int16)


def simulate_read(rng, transcript_len, polya_len, adapter_len=5500,
                  preleader_len=700, leader_len=900, seq_per_event=0.35,
                  noise=1.0, barcode=None, extra_adapter_at=None):
    """One read. Durations are in raw samples; ``barcode`` (0..3)
    modulates the adapter with that barcode's signature;
    ``extra_adapter_at`` (a fraction of the transcript) puts a second
    leader and adapter inside the transcript: a read of two molecules."""
    run_id = rng.bytes(16).hex()
    layout = [
        ('pre-leader', preleader_len),
        ('leader-low', leader_len * 2 // 3),
        ('leader-high', leader_len - leader_len * 2 // 3),
        ('adapter', adapter_len),
        ('polya-tail', polya_len),
        ('transcript', transcript_len),
    ]
    parts = []
    tr_start = 0
    for state, dur in layout:
        mu, sd = STATE_LEVELS[state]
        if state == 'transcript':
            # the transcript wanders between k-mer levels
            tr_start = sum(len(p) for p in parts)
            nlevels = max(2, -(-dur // EVENT_SAMPLES))
            levels = rng.normal(mu, sd, nlevels)
            seg = np.repeat(levels, EVENT_SAMPLES)[:dur] + \
                rng.normal(0, 2.0, dur)
            if extra_adapter_at is not None:
                at = int(dur * extra_adapter_at)
                ldur = min(900, max(0, dur - at))
                adur = min(4000, max(0, dur - at - ldur))
                seg[at:at + ldur] = rng.normal(*STATE_LEVELS['leader-high'],
                                               ldur)
                seg[at + ldur:at + ldur + adur] = rng.normal(
                    *STATE_LEVELS['adapter'], adur)
        else:
            seg = rng.normal(mu, sd * noise, dur)
            if state == 'adapter' and barcode is not None:
                t = np.arange(dur) / 15.0
                seg += BARCODE_AMPS[barcode] * np.sin(
                    2 * np.pi * BARCODE_FREQS[barcode] * t +
                    rng.uniform(0, 2 * np.pi))
        parts.append(seg)
    signal_pa = np.concatenate(parts).astype(np.float32)
    tr_end = len(signal_pa) - 1

    # basecalled sequence and events over the transcript region
    n_events = max(8, int((tr_end - tr_start + 1) / EVENT_SAMPLES))
    moves = (rng.uniform(size=n_events) < seq_per_event).astype(np.int64)
    moves[0] = 1
    seqlen = int(moves.sum()) + 4     # 5-mer model: k - 1 extra bases
    sequence = BASES[rng.integers(0, 4, seqlen)].tobytes().decode()
    qstring = (33 + rng.integers(4, 30, seqlen)).astype(
        np.uint8).tobytes().decode()
    starts = np.linspace(tr_start, tr_end - EVENT_SAMPLES,
                         n_events).astype(np.int64)
    lengths = np.maximum(np.diff(np.append(starts, tr_end)), 1)
    csum = np.concatenate([[0.0], np.cumsum(signal_pa, dtype=np.float64)])
    events = {
        'mean': (csum[starts + lengths] - csum[starts]) / lengths,
        'start': starts.astype(np.uint64),
        'move': moves,
        'p_model_state': rng.uniform(0.2, 0.95, n_events),
    }
    return Read(raw_dac=_to_dac(signal_pa), run_id=run_id, sequence=sequence,
                qstring=qstring, events=events, polya_len=polya_len,
                transcript_len=transcript_len,
                two_molecules=extra_adapter_at is not None, barcode=barcode)
