"""The read pool of a traffic mix: one general generator over the mix's
parameter file (``traffic/<name>.json``).

The pool is the mix's own, drawn from its ``pool_seed``: transcript and
poly(A) tail lengths in nucleotides, each read from the mix's quantile
function (``transcript_nt``, ``polya_nt``: points of (cumulative share,
length), linear between them) at n evenly spread shares, turned into raw
samples at ``samples_per_nt``, paired at random, and every signal. A run's ``--seed`` draws the order in which the
pool is served (``source.py``) and the reads judged, so runs of any two
seeds hold the same work in another order: the reads' extension chains,
which set a batch's poly(A) rounds, differ from pool to pool by more than
the host's noise."""

import json
import os

import numpy as np

from . import simulate

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'traffic')

KEYS = ('pool_seed', 'pool_reads', 'samples_per_nt', 'transcript_nt',
        'polya_nt', 'adapter_samples', 'barcodes', 'two_molecules_every',
        'extra_adapter_at', 'two_molecule_seq_per_event')


def load(name):
    """The parameters of traffic mix ``name``."""
    with open(os.path.join(TRAFFIC_DIR, name + '.json')) as f:
        params = json.load(f)
    missing = [key for key in KEYS if key not in params]
    if missing:
        raise ValueError('traffic {} lacks {}'.format(name, missing))
    return params


def seed_sequence(seed, *words):
    """A SeedSequence of the run's seed (any whole number) and ``words``."""
    return np.random.SeedSequence([seed % (1 << 64)] + list(words))


def lengths(quantiles, n, samples_per_nt):
    """n lengths in raw samples: the quantile function given by the
    points ``quantiles`` ([[share, nt], ...], shares rising from 0 to 1)
    at the centres of n equal bins of the shares."""
    shares, nts = zip(*quantiles)
    if shares[0] != 0 or shares[-1] != 1 or \
            any(b <= a for a, b in zip(shares, shares[1:])):
        raise ValueError('quantile shares must rise from 0 to 1: {}'
                         .format(quantiles))
    nt = np.interp((np.arange(n) + 0.5) / n, shares, nts)
    return np.round(nt * samples_per_nt).astype(np.int64)


def make_pool(params):
    """The pool's reads. Barcodes go 0 to ``barcodes - 1`` in turn; read
    i is two molecules when ``i % two_molecules_every == 3``."""
    rng = np.random.default_rng(seed_sequence(params['pool_seed'], 0))
    n = params['pool_reads']
    per_nt = params['samples_per_nt']
    transcripts = lengths(params['transcript_nt'], n,
                          per_nt)[rng.permutation(n)]
    tails = lengths(params['polya_nt'], n, per_nt)[rng.permutation(n)]
    reads = []
    for i in range(n):
        fused = i % params['two_molecules_every'] == 3
        extra = (dict(extra_adapter_at=params['extra_adapter_at'],
                      seq_per_event=params['two_molecule_seq_per_event'])
                 if fused else {})
        reads.append(simulate.simulate_read(
            rng, transcript_len=int(transcripts[i]),
            polya_len=int(tails[i]), adapter_len=params['adapter_samples'],
            barcode=i % params['barcodes'], **extra))
    return reads
