"""poreplex_torch event detection vs the JAX package: the peak detector's
emissions exactly equal to the XLA scan (ops.event_detection.detect_peaks)
and to the Pallas kernel in interpret mode, on both parameter sets of
tests/test_reference_c_parity.py; event starts exactly equal to the JAX op
and to the native C++ detector, means and stdvs within stated tolerances.
The cumulative sums follow XLA:CPU's association and equal the JAX
package's bit for bit. The CUDA kernel does not run here; chip_smoke.py
holds it against the plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreplex_tpu import native
from poreplex_tpu.ops import event_detection as jed
from poreplex_tpu.ops.pallas_event_detection import detect_peaks as \
    pallas_peaks
from poreplex_torch import kernels
from poreplex_torch.kernels import event_detection as ked
from poreplex_torch.ops import event_detection as ted, f32

PRESET = dict(window_length1=7, window_length2=20, threshold1=3.0,
              threshold2=8.0, peak_height=4.0)
CSUPPORT = dict(window_length1=30, window_length2=120, threshold1=3.0,
                threshold2=9.0, peak_height=8.0)
# the JAX op's event means come from the same prefix sums; the native
# detector accumulates in float64 (tolerances of tests/test_event_detection)
MEAN_RTOL, MEAN_ATOL = 2e-4, 2e-3
STDV_RTOL, STDV_ATOL = 2e-2, 5e-2


def steppy(rng, n_levels, level_len=(8, 90)):
    lens = rng.randint(level_len[0], level_len[1], n_levels)
    return (np.repeat(rng.normal(100, 8, n_levels), lens) +
            rng.normal(0, 1.2, lens.sum())).astype(np.float32)


def padded(sigs, width=None):
    T = width or max(len(s) for s in sigs)
    x = np.zeros((len(sigs), T), np.float32)
    for i, s in enumerate(sigs):
        x[i, :len(s)] = s[:T]
    return x, np.array([min(len(s), T) for s in sigs], np.int32)


@pytest.mark.parametrize('n,base', [(7, 16), (100, 16), (1000, 16),
                                    (8193, 16), (20, 32), (33, 32),
                                    (1057, 32), (8192, 32)])
def test_sums_follow_xla_cpu_bitwise(n, base):
    rng = np.random.RandomState(n)
    x = rng.normal(0, 10, (3, n)).astype(np.float32)
    if base == 16:
        got = f32.cumsum(torch.from_numpy(x)).numpy()
        ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    else:
        got = f32.rowsum(torch.from_numpy(x)).numpy()
        ref = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x))
    np.testing.assert_array_equal(got, ref)


def tstats(x, lens, params):
    center, cs, css = ted._centered_cumsums(torch.from_numpy(x),
                                            torch.from_numpy(lens))
    lt = torch.from_numpy(lens)
    return (ted.compute_tstat(cs, css, lt, params['window_length1']),
            ted.compute_tstat(cs, css, lt, params['window_length2']))


@pytest.mark.parametrize('params', [PRESET, CSUPPORT],
                         ids=['preset', 'csupport'])
@pytest.mark.parametrize('seed', [0, 1])
def test_peaks_equal_xla_and_pallas(params, seed):
    rng = np.random.RandomState(seed)
    sigs = [steppy(rng, 20 + 7 * k, (20, 200) if params is CSUPPORT
                   else (8, 90)) for k in range(5)]
    x, lens = padded(sigs, width=4096)
    t1, t2 = tstats(x, lens, params)
    args = (lens, params['threshold1'], params['threshold2'],
            params['window_length1'], params['window_length2'],
            params['peak_height'])
    ps, pl = ted.detect_peaks(t1, t2, torch.from_numpy(lens), *args[1:])
    assert int((ps >= 0).sum()) > 20
    j1, j2 = jnp.asarray(t1.numpy()), jnp.asarray(t2.numpy())
    for ref in (jed.detect_peaks(j1, j2, jnp.asarray(lens), *args[1:]),
                pallas_peaks(j1, j2, jnp.asarray(lens), *args[1:],
                             interpret=True)):
        np.testing.assert_array_equal(ps.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(ref[1]))

    before = dict(kernels.launches)
    ks, kl = ked.detect_peaks(t1, t2, torch.from_numpy(lens), *args[1:])
    assert kernels.launches == before          # CPU tensors: plain version
    assert torch.equal(ks, ps) and torch.equal(kl, pl)


@pytest.mark.parametrize('params', [PRESET, CSUPPORT],
                         ids=['preset', 'csupport'])
def test_short_detector_ignores_tstat2(params):
    """The long detector's t-statistics never reach the short detector, on
    the JAX op and on the port's plain version: the one-way coupling that
    lets the kernel run the two detectors as separate chains."""
    rng = np.random.RandomState(3)
    sigs = [steppy(rng, 25 + 9 * k, (20, 200) if params is CSUPPORT
                   else (8, 90)) for k in range(4)]
    x, lens = padded(sigs, width=2048)
    t1, t2 = tstats(x, lens, params)
    t2_other = t2 * torch.from_numpy(
        rng.uniform(0.0, 3.0, t2.shape).astype(np.float32))
    args = (params['threshold1'], params['threshold2'],
            params['window_length1'], params['window_length2'],
            params['peak_height'])
    lt = torch.from_numpy(lens)
    ps, pl = ted.detect_peaks(t1, t2, lt, *args)
    ps2, pl2 = ted.detect_peaks(t1, t2_other, lt, *args)
    assert int((ps >= 0).sum()) > 10
    assert torch.equal(ps, ps2) and not torch.equal(pl, pl2)
    j1, jl = jnp.asarray(t1.numpy()), jnp.asarray(lens)
    ref = jed.detect_peaks(j1, jnp.asarray(t2.numpy()), jl, *args)
    ref2 = jed.detect_peaks(j1, jnp.asarray(t2_other.numpy()), jl, *args)
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(ref2[0]))
    np.testing.assert_array_equal(np.asarray(ref[0]), ps.numpy())
    np.testing.assert_array_equal(np.asarray(ref2[1]), pl2.numpy())


def csupport_signal():
    """The signal on which tests/test_reference_c_parity.py holds the JAX
    op to the reference C at the csupport defaults."""
    rng = np.random.RandomState(77)
    lens = rng.randint(40, 400, 60)
    return (np.repeat(rng.normal(95, 9, 60), lens) +
            rng.normal(0, 1.5, lens.sum())).astype(np.float32)


@pytest.mark.parametrize('params', [PRESET, CSUPPORT],
                         ids=['preset', 'csupport'])
def test_events_match_jax_and_native(params):
    rng = np.random.RandomState(7)
    sigs = ([steppy(rng, 30 + 5 * k) for k in range(5)] if params is PRESET
            else [csupport_signal()])
    x, lens = padded(sigs)
    out = ted.detect_events(torch.from_numpy(x), torch.from_numpy(lens),
                            **params)
    ref = jed.detect_events(jnp.asarray(x), jnp.asarray(lens), **params)
    np.testing.assert_array_equal(out['n_events'].numpy(),
                                  np.asarray(ref['n_events']))
    for i, s in enumerate(sigs):
        n = int(out['n_events'][i])
        assert n > 20
        np.testing.assert_array_equal(out['start'][i, :n].numpy(),
                                      np.asarray(ref['start'][i, :n]))
        for key in ('length', 'mean', 'stdv'):
            np.testing.assert_allclose(out[key][i, :n].numpy(),
                                       np.asarray(ref[key][i, :n]),
                                       rtol=1e-6, atol=1e-5)
        ev = native.detect_events(s, **params)
        assert n == len(ev)
        np.testing.assert_array_equal(out['start'][i, :n].numpy(),
                                      ev['start'])
        np.testing.assert_allclose(out['mean'][i, :n].numpy(), ev['mean'],
                                   rtol=MEAN_RTOL, atol=MEAN_ATOL)
        np.testing.assert_allclose(out['stdv'][i, :n].numpy(), ev['stdv'],
                                   rtol=STDV_RTOL, atol=STDV_ATOL)
        np.testing.assert_array_equal(out['length'][i, :n].numpy(),
                                      ev['length'])


def test_short_signal_degenerate_event():
    """Shorter than 2w: no peaks, one degenerate event [0, 0) with NaN
    mean and stdv 0, as the C code and the JAX op give."""
    out = ted.detect_events(torch.full((1, 30), 90.0),
                            torch.tensor([30]), **PRESET)
    assert int(out['n_events'][0]) == 1
    assert float(out['length'][0, 0]) == 0.0
    assert np.isnan(float(out['mean'][0, 0]))
    assert float(out['stdv'][0, 0]) == 0.0


def test_padding_and_truncation():
    """Padding past a lane's length changes nothing; a table narrower
    than the true peak count is flagged as truncated."""
    rng = np.random.RandomState(11)
    sig = steppy(rng, 20)
    L = len(sig)
    x2 = np.zeros((1, L + 500), np.float32)
    x2[0, :L] = sig
    out1 = ted.detect_events(torch.from_numpy(sig[None]), torch.tensor([L]),
                             **PRESET)
    out2 = ted.detect_events(torch.from_numpy(x2), torch.tensor([L]),
                             **PRESET)
    n = int(out1['n_events'][0])
    assert n == int(out2['n_events'][0]) > 5
    assert torch.equal(out1['start'][0, :n], out2['start'][0, :n])
    assert not bool(out1['peaks_truncated'][0])
    cut = ted.detect_events(torch.from_numpy(sig[None]), torch.tensor([L]),
                            max_peaks=4, **PRESET)
    assert bool(cut['peaks_truncated'][0])
    assert int(cut['n_events'][0]) == 5
