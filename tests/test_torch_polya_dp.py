"""poreplex_torch poly(A) interval DP vs the JAX package: bit-identical to
the XLA formulation (ops.polya_dp.dp_core) and to the Pallas kernel in
interpret mode, and equal to the exhaustive oracle, on the cases of
tests/test_polya_dp.py and on simulate.dp_cases (ties, deaths at the
CUDA kernel's chunk and span edges, a budget at the tolerance, event
counts of 1 and K, K from 1 to 1500). All arithmetic is int32, so there
is no tolerance. The CUDA kernel does not run here; chip_smoke.py holds
it against the plain version on the card, on the same generator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreplex_tpu.ops import polya_dp as jdp
from poreplex_tpu.ops.pallas_polya_dp import dp_pallas
from poreplex_tpu.refimpl.polya_dp import find_best_polya_interval as ref_dp
from poreplex_torch import kernels
from poreplex_torch.kernels import polya_dp as kdp
from poreplex_torch.ops import polya_dp as tdp
from poreplex_torch.simulate import dp_cases

# events of each adversarial row held against the O(n^2) oracle
ORACLE_EVENTS = 96


def port(ip, ln, n):
    return [t.numpy() for t in tdp.dp_core(torch.from_numpy(ip),
                                           torch.from_numpy(ln),
                                           torch.from_numpy(n), 1.5, 110)]


def run_batch(cases, kmax=64):
    B = len(cases)
    ip = np.zeros((B, kmax), bool)
    ln = np.zeros((B, kmax), np.float32)
    n = np.zeros(B, np.int32)
    for i, (is_p, length) in enumerate(cases):
        ip[i, :len(is_p)] = is_p
        ln[i, :len(is_p)] = length
        n[i] = len(is_p)
    return ip, ln, n


@pytest.mark.parametrize('seed', range(4))
def test_matches_xla_and_pallas(seed):
    rng = np.random.RandomState(100 + seed)
    B, K = 16, 1024
    ip = rng.uniform(size=(B, K)) < 0.6
    ln = rng.uniform(1, 300, (B, K)).astype(np.float32)
    n = rng.randint(1, K + 1, B).astype(np.int32)
    got = port(ip, ln, n)
    for ref in (jdp.find_best_polya_interval(jnp.asarray(ip),
                                             jnp.asarray(ln), jnp.asarray(n)),
                dp_pallas(jnp.asarray(ip), jnp.asarray(ln), jnp.asarray(n),
                          interpret=True)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
            assert a.dtype == np.int32

    before = dict(kernels.launches)
    wrapped = kdp.dp(torch.from_numpy(ip), torch.from_numpy(ip),
                     torch.from_numpy(ln), torch.from_numpy(n), 1.5, 110)
    assert kernels.launches == before          # CPU tensors: plain version
    for a, b in zip(wrapped, got):
        np.testing.assert_array_equal(a.numpy(), np.concatenate([b, b]))


@pytest.mark.parametrize('kmax', [1, 33, 511, 512, 528, 1024, 1040,
                                  1500])
def test_adversarial_cases(kmax):
    ip, ln, n = dp_cases(np.random.default_rng(kmax), 24, kmax)
    got = port(ip, ln, n)
    assert (got[2] > 0).any() and (got[2] == 0).any()
    for ref in (jdp.find_best_polya_interval(jnp.asarray(ip),
                                             jnp.asarray(ln), jnp.asarray(n)),
                dp_pallas(jnp.asarray(ip), jnp.asarray(ln), jnp.asarray(n),
                          interpret=True)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))

    # the oracle on each row's first events
    cut = np.minimum(n, ORACLE_EVENTS)
    s, e, v = port(ip, ln, cut)
    for i, m in enumerate(cut):
        expected = ref_dp(ip[i, :m], ln[i, :m])
        if expected is None:
            assert v[i] <= 0
        else:
            assert (s[i], e[i]) == expected


@pytest.mark.parametrize('adversarial_first', [True, False])
def test_wrapper_takes_both_packs(adversarial_first):
    """Two masks over one length and count: the rows of the first, then
    those of the second, as the plain version gives them stacked. The
    adversarial mask goes in either pack, as chip_smoke.py gives it to the
    kernel."""
    rng = np.random.default_rng(7)
    ip, ln, n = dp_cases(rng, 12, 40)
    other = rng.uniform(size=ip.shape) < 0.5
    a, b = (ip, other) if adversarial_first else (other, ip)
    before = dict(kernels.launches)
    got = kdp.dp(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(ln), torch.from_numpy(n), 1.5, 110)
    assert kernels.launches == before
    ref = port(np.concatenate([a, b]), np.concatenate([ln, ln]),
               np.concatenate([n, n]))
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y)


@pytest.mark.parametrize('seed', range(6))
def test_random_cases_match_oracle(seed):
    rng = np.random.RandomState(seed)
    cases = []
    for _ in range(8):
        n = rng.randint(1, 60)
        cases.append((rng.uniform(size=n) < 0.6,
                      rng.uniform(1, 300, n).astype(np.float32)))
    s, e, v = port(*run_batch(cases))
    for i, (is_p, length) in enumerate(cases):
        expected = ref_dp(is_p, length)
        if expected is None:
            assert v[i] <= 0
        else:
            assert (s[i], e[i]) == expected


@pytest.mark.parametrize('is_p,length,expect', [
    ([False] * 10, [50.0] * 10, None),                 # all spikes
    ([False, True, False], [100.0, 400.0, 80.0], (1, 1, 400)),
    ([True, False, True], [200.0, 50.0, 200.0], (0, 2, 325)),  # bridged
    ([True, False, True], [10.0, 5.0, 10.0], (0, 2, 13)),      # -7.5 -> -7
])
def test_budget_and_truncation(is_p, length, expect):
    ip, ln, n = run_batch([(np.array(is_p), np.array(length, np.float32))])
    s, e, v = port(ip, ln, n)
    if expect is None:
        assert v[0] <= 0
    else:
        assert (s[0], e[0], v[0]) == expect


def test_long_spike_splits_interval():
    is_p = np.array([True, False, True])
    length = np.array([200.0, 150.0, 200.0], np.float32)
    s, e, v = port(*run_batch([(is_p, length)]))
    assert ref_dp(is_p, length) == (int(s[0]), int(e[0]))
    assert (s[0], e[0]) in ((0, 0), (2, 2))
