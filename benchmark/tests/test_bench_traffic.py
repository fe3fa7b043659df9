"""The traffic generator: a mix's pool repeats, another pool seed gives
other signals on the same set of lengths, within the mix file's
parameters."""

import os

import numpy as np
import pytest

from benchmark.harness import traffic

SEED = 2 ** 31 + 12345


def small(name, n=32):
    return dict(traffic.load(name), pool_reads=n)


def traffic_names():
    return sorted(fn[:-len('.json')] for fn in os.listdir(traffic.TRAFFIC_DIR)
                  if fn.endswith('.json'))


def bounds(params, key):
    nts = [nt for _, nt in params[key]]
    per_nt = params['samples_per_nt']
    return min(nts) * per_nt, max(nts) * per_nt


@pytest.mark.parametrize('name', traffic_names())
def test_pool_repeats_and_matches_its_file(name):
    params = small(name)
    a = traffic.make_pool(params)
    b = traffic.make_pool(params)
    c = traffic.make_pool(dict(params, pool_seed=SEED))
    assert len(a) == params['pool_reads']
    assert all(np.array_equal(x.raw_dac, y.raw_dac) and
               x.sequence == y.sequence for x, y in zip(a, b))
    assert not all(np.array_equal(x.raw_dac, y.raw_dac)
                   for x, y in zip(a, c))
    # the same lengths for every pool seed, in another order
    assert sorted(r.polya_len for r in a) == sorted(r.polya_len for r in c)
    assert sorted(r.transcript_len for r in a) == \
        sorted(r.transcript_len for r in c)
    lo, hi = bounds(params, 'polya_nt')
    assert all(lo <= r.polya_len <= hi for r in a)
    lo, hi = bounds(params, 'transcript_nt')
    assert all(lo <= r.transcript_len <= hi for r in a)
    assert [r.barcode for r in a] == [i % params['barcodes']
                                      for i in range(len(a))]
    assert [i for i, r in enumerate(a) if r.two_molecules] == \
        [i for i in range(len(a)) if i % params['two_molecules_every'] == 3]
    for r in a:
        assert r.raw_dac.dtype == np.int16
        assert len(r.sequence) == len(r.qstring) == \
            int(r.events['move'].sum()) + 4


def test_every_read_holds_its_segments():
    read = traffic.make_pool(small('reads.mrna', 4))[0]
    body = 700 + 900 + 5500
    assert read.duration == body + read.polya_len + read.transcript_len


@pytest.mark.parametrize('name', traffic_names())
def test_lengths_follow_the_quantile_function(name):
    """A large pool's lengths read the file's quantiles back."""
    params = traffic.load(name)
    per_nt = params['samples_per_nt']
    for key in ('polya_nt', 'transcript_nt'):
        got = traffic.lengths(params[key], 4000, per_nt) / per_nt
        for share, nt in params[key]:
            assert abs(np.quantile(got, share) - nt) <= \
                0.01 * nt + 1, (key, share)


def test_quantile_shares_must_rise_from_0_to_1():
    for bad in ([[0.0, 1], [0.5, 2]], [[0.1, 1], [1.0, 2]],
                [[0.0, 1], [0.5, 2], [0.5, 3], [1.0, 4]]):
        with pytest.raises(ValueError):
            traffic.lengths(bad, 8, 43)
