"""poreplex_torch poly(A): the fused round (ops.polya_round) vs the JAX
package's polya_round_core on the same wire (integer columns of the heads
exactly equal, float columns within 1e-5 relative, spike tables equal),
and the PolyaAnalyzer's rounds vs the sequential oracle
(refimpl/polya_analyzer.py) on the cases of tests/test_polya_pipeline.py:
plain, spiky, long and shifted tails, open ends, extension chains, the
spike-overflow fallback and the truncated-table retry."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreplex_tpu.config import load_preset
from poreplex_tpu.ops import polya_round as jround
from poreplex_tpu.refimpl.polya_analyzer import PolyaOracle
from poreplex_torch.ops import polya_round as tround
from poreplex_torch.pipeline import polya as polya_mod
from poreplex_torch.pipeline.polya import PolyaAnalyzer
from test_polya_pipeline import (FakeDacRead, FakeRead, build_signal,
                                 rough_range_for, RATE, STRIDE)

FLOAT_RTOL = 1e-5
# head columns that hold integers (pack A, pack B, globals)
INT_COLS = [0, 1, 2, 3, 6, 7, 8, 9]
INT_COLS = (INT_COLS + [c + tround.PACK_HEAD for c in INT_COLS] +
            [20, 21, 25, 26])


@pytest.fixture(scope='module')
def polya_config():
    return load_preset()['polya_dwell']


def round_params(config, max_peaks, max_spikes):
    ed, rc = config['event_detection'], config['recalibrate_shifted_signal']
    return dict(
        window_length1=ed['window_length1'],
        window_length2=ed['window_length2'],
        threshold1=float(ed['threshold1']),
        threshold2=float(ed['threshold2']),
        peak_height=float(ed['peak_height']), max_peaks=max_peaks,
        spike_weight=float(config['spike_weight']),
        spike_tolerance=int(config['spike_tolerance']),
        max_spikes=max_spikes,
        median_pre_filter=int(config['median_pre_filter']),
        stdv_lo=float(config['polya_stdv_range'][0]),
        stdv_hi=float(config['polya_stdv_range'][1]),
        recal_max_dist=int(rc['max_dist_from_adapter']),
        recal_max_stdv=float(rc['max_stdv']),
        recal_zr=float(config['polya_mean_dist'][1] *
                       config['polya_mean_z_cutoff']))


def six_windows(polya_config):
    """Six windows (tails plain, spiky, shifted, one DAC window) of one
    8192-sample launch: (u16 stream, meta [6, META_COLS], round
    parameters)."""
    rng = np.random.RandomState(3)
    cutoff = (108.95 - 2 * 2.55, 108.95 + 2 * 2.55)
    wires, rows = [], []
    for k in range(6):
        sig = build_signal(rng, adapter_len=600, polya_len=1500 + 400 * k,
                           spikes=k % 3, transcript_len=2500,
                           tail_level=100.0 if k == 4 else 108.95)
        if k == 5:
            q, (lo, step) = polya_mod.quantize(
                np.round(sig / 0.1428).astype(np.int16), (0.1428, 0.3))
        else:
            q, (lo, step) = polya_mod.quantize(sig, (1.0, 0.0))
        rng_k = (96.0, 104.0) if k == 3 else cutoff
        rows.append((sum(len(w) for w in wires), len(q), 400, *rng_k, lo,
                     step))
        wires.append(q)
    return (np.concatenate(wires), np.array(rows, np.float32),
            round_params(polya_config, max_peaks=511, max_spikes=8))


def widened(stream):
    return torch.from_numpy(stream.view(np.int16)).to(torch.int32) & 0xFFFF


def test_round_heads_match_jax(polya_config):
    """Six windows (tails plain, spiky, shifted, one DAC window) in one
    8192-sample launch on both packages."""
    stream, meta, params = six_windows(polya_config)

    heads, spikes = tround.polya_round(
        widened(stream), torch.from_numpy(meta), blen=8192, **params)
    jheads, jstream = jax.jit(functools.partial(
        jround.polya_round_core, blen=8192, use_pallas=False,
        interpret=False, **params))(jnp.asarray(stream), jnp.asarray(meta))
    heads, jheads = heads.numpy(), np.asarray(jheads)
    assert heads.shape == jheads.shape == (6, tround.HEAD_COLS)
    assert heads[:, 0].sum() >= 4                   # intervals found
    np.testing.assert_array_equal(heads[:, INT_COLS], jheads[:, INT_COLS])
    np.testing.assert_allclose(heads, jheads, rtol=FLOAT_RTOL, atol=1e-6)

    got = tround.unpack_rows(heads, spikes.numpy(), 8)
    ref = jround.unpack_rows(jheads, np.asarray(jstream), 6, 8)
    assert sum(len(r.a.spikes()) for r in got) > 0
    for g, r in zip(got, ref):
        for gp, rp in ((g.a, r.a), (g.b, r.b)):
            gs, rs = gp.spikes(), rp.spikes()
            assert [s[0] for s in gs] == [s[0] for s in rs]
            for a, b in zip(gs, rs):
                np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL)


def test_padded_round_leaves_real_rows_bit_equal(polya_config):
    """The six windows padded as a captured round pads them: all-zero
    meta rows up to a capacity of 8, in a wire of 8 x 8192 + 1 samples
    whose tail past the windows holds stale samples. Every real row's
    heads and spikes keep their bits."""
    stream, meta, params = six_windows(polya_config)
    heads, spikes = tround.polya_round(
        widened(stream), torch.from_numpy(meta), blen=8192, **params)
    buffer = np.random.RandomState(4).randint(
        0, 1 << 16, 8 * 8192 + 1).astype(np.uint16)
    buffer[:len(stream)] = stream
    padded = tround.pad_rows(meta, 8)
    assert padded.shape == (8, tround.META_COLS) and not padded[6:].any()
    got = tround.real_rows(*tround.polya_round(
        widened(buffer), torch.from_numpy(padded), blen=8192, **params), 6)
    for g, ref in zip(got, (heads, spikes)):
        assert g.shape == ref.shape
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      ref.numpy().view(np.int32))


def test_row_capacity_is_a_bounded_power_of_two():
    """8 rows for 1 to 8 windows, the next power of two above that, and
    never past the launch cap of a bucket."""
    for blen in polya_mod._BUCKETS:
        cap = polya_mod.launch_rows(blen)
        for rows in range(1, cap + 1):
            capacity = polya_mod.row_capacity(rows, blen)
            assert rows <= capacity <= cap
            assert capacity == (8 if rows <= 8 else
                                1 << (rows - 1).bit_length())


def test_graph_key_differs_by_every_round_parameter(polya_config):
    """A captured round is keyed by its card, bucket, row capacity and
    every parameter baked into it: a change to any one of them gives
    another key, the same parameters in another order the same key."""
    analyzer = PolyaAnalyzer(polya_config, device='cpu')
    params = dict(analyzer._round, max_peaks=511, max_spikes=128)
    assert set(params) == set(round_params(polya_config, 511, 128))
    key = tround.graph_key('cuda:0', 8192, 8, params)
    assert key == tround.graph_key(
        'cuda:0', 8192, 8, dict(reversed(list(params.items()))))
    others = [tround.graph_key('cuda:1', 8192, 8, params),
              tround.graph_key('cuda:0', 16384, 8, params),
              tround.graph_key('cuda:0', 8192, 16, params)]
    for name, value in params.items():
        changed = dict(params, **{name: value * 2 + 1})
        others.append(tround.graph_key('cuda:0', 8192, 8, changed))
    assert len(others) == 3 + len(params)
    assert key not in others and len(set(others)) == len(others)


def test_capture_counts_move_to_replays():
    """A capture's kernel counts are taken off the totals and added back
    once a replay."""
    from poreplex_torch import kernels
    kernels.reset_launches()
    kernels.count('polya_dp', 'dp_kernel')
    before = kernels.counts()
    kernels.count('detect_peaks', 'peaks_kernel')
    kernels.count('polya_dp', 'dp_kernel')
    taken = kernels.take_counts(before)
    assert kernels.counts() == before
    for _ in range(3):
        kernels.add_counts(taken)
    assert kernels.launches['detect_peaks'] == 3
    assert kernels.launches['polya_dp'] == 4
    assert kernels.instantiations == {'peaks_kernel': 3, 'dp_kernel': 4}
    kernels.reset_launches()


@pytest.mark.parametrize('k', [1, 7])
def test_medfilt_matches_scipy(k):
    from scipy.signal import medfilt
    rng = np.random.RandomState(k)
    x = rng.normal(100, 10, (3, 50)).astype(np.float32)
    got = tround.medfilt(torch.from_numpy(x), k).numpy()
    for row, ref in zip(got, x):
        np.testing.assert_array_equal(row, medfilt(ref, k))


def run_and_compare(config, items, spikes='values'):
    """Each read's tail vs the oracle's: begin, end and dwell exactly,
    the spike list by count ('count') or also by values ('values')."""
    analyzer = PolyaAnalyzer(config, device='cpu')
    analyzer.process_batch(items, STRIDE)
    found = 0
    for read, rough in items:
        oracle = PolyaOracle(config)
        oracle(read.scaled_raw if hasattr(read, 'scaled_raw') else
               read.oracle_signal, RATE, rough, STRIDE)
        if oracle.result is None:
            assert read.polya is None, read.polya
            continue
        found += 1
        assert read.polya is not None, 'the oracle found a tail'
        assert read.polya['begin'] == oracle.result['begin']
        assert read.polya['end'] == oracle.result['end']
        assert abs(read.polya['dwell_time'] -
                   oracle.result['dwell_time']) < 1e-6
        if spikes:
            assert len(read.polya['spikes']) == len(oracle.result['spikes'])
        if spikes == 'values':
            for got, exp in zip(read.polya['spikes'],
                                oracle.result['spikes']):
                assert got[0] == exp[0]
                np.testing.assert_allclose(got[1:], exp[1:], atol=1e-3)
    return found


@pytest.mark.parametrize('case', [
    dict(seed=0, spikes=0),
    dict(seed=1, spikes=2),
    dict(seed=2, spikes=0, polya_len=900),
    dict(seed=3, spikes=1, polya_len=5000),          # long tail
    dict(seed=4, spikes=0, tail_level=100.0),        # shifted level
    dict(seed=5, spikes=0, with_end=False),          # no rough end
    dict(seed=6, spikes=3, polya_len=3500),
])
def test_batch_matches_oracle(polya_config, case):
    case = dict(case)
    rng = np.random.RandomState(case.pop('seed'))
    with_end = case.pop('with_end', True)
    sig = build_signal(rng, adapter_len=4000, **case)
    rough = rough_range_for(4000, case.get('polya_len', 2500), with_end)
    run_and_compare(polya_config, [(FakeRead(sig), rough)])


@pytest.mark.parametrize('case', [
    dict(seed=20, polya_len=9000, rough_end_at=1500),
    dict(seed=21, polya_len=12000, rough_end_at=1200, spikes=2),
    dict(seed=22, polya_len=8000, rough_end_at=1500, tail_level=100.0),
])
def test_extension_chains_match_oracle(polya_config, case):
    """Rough ends far too early: the open-end extension runs round after
    round (and recalibrates in the shifted case) until the oracle's
    result."""
    case = dict(case)
    rng = np.random.RandomState(case.pop('seed'))
    rough = (4000 // STRIDE, (4000 + case.pop('rough_end_at')) // STRIDE)
    sig = build_signal(rng, adapter_len=4000, **case)
    run_and_compare(polya_config, [(FakeRead(sig), rough)], spikes='count')


def test_batch_of_mixed_reads(polya_config):
    rng = np.random.RandomState(10)
    items = []
    for k in range(6):
        sig = build_signal(rng, polya_len=800 + 700 * k, spikes=k % 3)
        items.append((FakeRead(sig), rough_range_for(4000, 800 + 700 * k)))
    assert run_and_compare(polya_config, items) >= 4


def test_spike_overflow_fallback_matches_oracle(polya_config, monkeypatch):
    """With two spike rows per pack, a spiky tail recomputes its spikes
    from the window's full event table and still gives the oracle's."""
    monkeypatch.setattr(polya_mod, '_MAX_SPIKES', 2)
    calls = []
    original = PolyaAnalyzer._spikes_fallback
    monkeypatch.setattr(PolyaAnalyzer, '_spikes_fallback',
                        lambda self, t, pack: calls.append(1) or
                        original(self, t, pack))
    rng = np.random.RandomState(33)
    sig = build_signal(rng, polya_len=3500, spikes=3)
    assert run_and_compare(polya_config,
                           [(FakeRead(sig), rough_range_for(4000, 3500))])
    assert calls


def test_truncated_table_retries_in_larger_bucket(polya_config,
                                                  monkeypatch):
    """A table of 8 events in the smallest bucket truncates the window's
    events: the round flags it and the retry in the next bucket gives the
    oracle's result."""
    monkeypatch.setitem(polya_mod._BUCKET_PEAKS, 8192, 8)
    blens = []
    original = PolyaAnalyzer._launch
    monkeypatch.setattr(PolyaAnalyzer, '_launch',
                        lambda self, chunk, blen: blens.append(blen) or
                        original(self, chunk, blen))
    rng = np.random.RandomState(50)
    sig = build_signal(rng, polya_len=2400, spikes=2)
    assert run_and_compare(polya_config,
                           [(FakeRead(sig), rough_range_for(4000, 2400))],
                           spikes='count')
    assert blens[:2] == [8192, 16384]


def test_dac_read_matches_oracle():
    """A ReadRecord-style read (integer DAC, dac_window) against the
    oracle on its exact scaled-pA signal."""
    rng = np.random.RandomState(11)
    scaled = build_signal(rng, adapter_len=3800, polya_len=2400, spikes=1)
    calib = (1170.0 / 8192.0, 5.0)
    dac = np.clip(np.round(scaled / calib[0] - calib[1]),
                  -32768, 32767).astype(np.int16)
    read = FakeDacRead(dac, calib, (1.0, 0.0))
    a, b = np.float32(calib[0]), np.float32(calib[0] * calib[1])
    read.oracle_signal = (a * dac.astype(np.float32) + b).astype(np.float32)
    preset = load_preset()
    run_and_compare(preset['polya_dwell'],
                    [(read, rough_range_for(3800, 2400))])
    assert read.polya is not None
