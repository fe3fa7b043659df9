"""The shapes of every model and HMM the JAX package accepts, on the
port's side of the CPU: the plain LSTMs and Viterbis (what the CUDA
wrappers run for CPU tensors, and what chip_smoke.py holds the kernels
against on the card) against the JAX package's Pallas entries in
interpret mode, and the wrappers' choice of kernel design for each shape
(``kernels.lstm.plan``, ``kernels.viterbi.plan``), checked on 'meta'
tensors, which take the kernel path without a card.

LSTMs: B = 3, T = 50, H in {1, 20, 52, 56, 96, 128}, input width 1 and 3, and
stacked layers of unequal widths; within 5e-5 absolute (the bound of
tests/test_torch_rnn.py). Viterbi: 1, 3, 7 and 8 states x 1, 3, 4 and 5
components (5: the kernels' loop over K), and the tie HMM at 7 and 8
states; paths and extents exactly
equal, logp within 1e-6 relative (float32 holds a logp of some -300 to
3e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreplex_tpu.ops import pallas_rnn, pallas_viterbi
from poreplex_torch import kernels, simulate
from poreplex_torch.kernels import _build
from poreplex_torch.kernels import lstm as klstm
from poreplex_torch.kernels import viterbi as kvit
from poreplex_torch.ops import rnn
from poreplex_torch.ops import viterbi as vit_ops

ATOL = 5e-5
LOGP_RTOL = 1e-6
HIDDEN = (1, 20, 52, 56, 96, 128)
INPUTS = (1, 3)
STACKED_PAIRS = ((64, 32), (32, 96))
STATES = (1, 3, 7, 8)
COMPONENTS = (1, 3, 4, 5)


def spread(fan_in):
    """The weights' spread: 0.3, that of tests/test_torch_rnn.py's layers
    and about that of the shipped networks' LSTM(48) layers, shrunk as
    1 / sqrt(fan-in) past 48 inputs, so that a wide layer's pre-activations
    spread as a trained one's do (at 0.3 an LSTM(128) runs into a regime
    where the float32 rounding of either package's sums grows step by
    step)."""
    return 0.3 * min(1.0, (48.0 / fan_in) ** 0.5)


def random_layer(rng, inputs, hidden):
    return {
        'kernel': rng.normal(0, spread(inputs), (inputs, 4 * hidden)).astype(
            np.float32),
        'recurrent': rng.normal(0, spread(hidden), (hidden, 4 * hidden)
                                ).astype(np.float32),
        'bias': rng.normal(0, 0.1, (4 * hidden,)).astype(np.float32),
    }


def as_jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def as_torch(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


# (wrapper, its JAX Pallas entry, the layers' (input, hidden) shapes)
def lstm_cases():
    cases = []
    for inputs in INPUTS:
        for hidden in HIDDEN:
            cases += [
                ('lstm2_stacked', inputs, ((inputs, hidden),
                                           (hidden, hidden))),
                ('bidirectional_lstm', inputs, ((inputs, hidden),
                                                (inputs, hidden))),
                ('lstm_last', inputs, ((inputs, hidden),)),
            ]
        cases += [('lstm2_stacked', inputs, ((inputs, h1), (h1, h2)))
                  for h1, h2 in STACKED_PAIRS]
    return cases


LSTM_CASES = lstm_cases()
PALLAS = {'lstm2_stacked': pallas_rnn.lstm2_stacked_pallas,
          'bidirectional_lstm': pallas_rnn.bidirectional_lstm_pallas,
          'lstm_last': pallas_rnn.lstm_last_pallas}


def case_id(case):
    name, inputs, layers = case
    return '{}-I{}-H{}'.format(name, inputs,
                               '-'.join(str(h) for _, h in layers))


@pytest.mark.parametrize('case', LSTM_CASES, ids=case_id)
def test_plain_lstm_matches_pallas(case):
    name, inputs, layers = case
    rng = np.random.RandomState(len(case_id(case)))
    params = [random_layer(rng, i, h) for i, h in layers]
    xs = rng.normal(0, 1, (3, 50, inputs)).astype(np.float32)

    before = dict(kernels.launches)
    got = getattr(klstm, name)(*[as_torch(p) for p in params],
                               torch.from_numpy(xs)).numpy()
    assert kernels.launches == before      # CPU tensors: plain version
    ref = np.asarray(PALLAS[name](*[as_jax(p) for p in params],
                                  jnp.asarray(xs), interpret=True))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def stacked_readings(seed, scale):
    """The stacked LSTM(128) at [37, 61], input width 1 (the card's grid
    shape), with layers spread ``scale`` (None: ``spread``): max abs
    differences plain - Pallas, plain - float64 and Pallas - float64, the
    float64 result being the plain version's on the same weights."""
    rng = np.random.RandomState(seed)

    def layer(inputs, hidden):
        p = random_layer(rng, inputs, hidden)
        if scale is not None:
            p['kernel'] = p['kernel'] / spread(inputs) * scale
            p['recurrent'] = p['recurrent'] / spread(hidden) * scale
        return {k: v.astype(np.float32) for k, v in p.items()}

    params = [layer(1, 128), layer(128, 128)]
    xs = rng.normal(0, 1, (37, 61, 1)).astype(np.float32)
    plain = rnn.lstm2_stacked(*[as_torch(p) for p in params],
                              torch.from_numpy(xs)).numpy()
    exact = rnn.lstm2_stacked(
        *[{k: v.double() for k, v in as_torch(p).items()} for p in params],
        torch.from_numpy(xs).double()).numpy()
    pallas = np.asarray(pallas_rnn.lstm2_stacked_pallas(
        *[as_jax(p) for p in params], jnp.asarray(xs), interpret=True))
    return (float(np.abs(plain - pallas).max()),
            float(np.abs(plain - exact).max()),
            float(np.abs(pallas - exact).max()))


@pytest.mark.parametrize('seed', range(3))
def test_full_spread_wide_lstm_is_float32_limited(seed):
    """Why the layers above spread less past 48 inputs: at 0.3 the stacked
    LSTM(128) amplifies float32 rounding past ATOL in either package, so
    one of the plain version and interpret-mode Pallas leaves the float64
    result by more than ATOL; at ``spread`` both stay within ATOL / 5 of
    it. Prints the readings (run with -s)."""
    full = stacked_readings(seed, 0.3)
    shrunk = stacked_readings(seed, None)
    for label, (pp, p64, j64) in (('0.3', full), ('shrunk', shrunk)):
        print('stacked LSTM(128) [37, 61], seed {}, spread {}: plain - '
              'Pallas {:.3g}, plain - float64 {:.3g}, Pallas - float64 '
              '{:.3g}'.format(seed, label, pp, p64, j64))
    assert max(full[1:]) > ATOL
    assert max(shrunk[1:]) < ATOL / 5


CLUSTERS = (1, 2, 4, 8)


def block_smem(kernel, hiddens, cluster, rows, rank=None):
    """Shared memory bytes of a block of a general launch in a cluster of
    ``cluster`` keeping ``rows`` rows of its units' columns of each weight
    matrix: 16 bytes of step barriers, 16 bytes a row and unit it owns, 16
    a unit it owns (c of 4 reads) and 32 a unit of the layer (h of 4 reads
    twice). ``rank``: that block's own units; None: the most any block
    owns (what is allocated)."""
    def units(h):
        if rank is None:
            return -(-h // cluster)
        return (rank + 1) * h // cluster - rank * h // cluster
    if kernel == 'lstm2_stacked_general_kernel':
        h1, h2 = hiddens
        u1, u2 = units(h1), units(h2)
        return (16 + 16 * (min(rows, h1) * (u1 + u2) + min(rows, h2) * u2) +
                16 * (u1 + u2) + 32 * (h1 + h2))
    h, = hiddens
    return 16 + 16 * rows * units(h) + 16 * units(h) + 32 * h


def expected_cluster(kernel, hiddens):
    """The smallest portable cluster whose blocks hold every weight row,
    else 8 with the most rows that fit: (cluster, rows)."""
    most = max(hiddens)
    for cluster in CLUSTERS:
        if block_smem(kernel, hiddens, cluster, most) <= klstm.SMEM_BYTES:
            return cluster, most
    rows = most
    while block_smem(kernel, hiddens, 8, rows) > klstm.SMEM_BYTES:
        rows -= 1
    return 8, rows


def warps(units, most):
    """Threads for ``units`` units at 4 lanes a unit, whole warps, at
    most ``most``."""
    return min(most, -(-units // 8) * 32)


# the register kernels' instantiated widths: the shipped networks', and
# for the BiLSTM every multiple of 8 from 48 to 64
REGISTER_WIDTHS = {'lstm2_stacked': (48,), 'bidirectional_lstm': (48, 56, 64),
                   'lstm_last': (48, 64)}


def expected_plan(name, inputs, layers, batch):
    """The design the wrapper must pick: the register kernels at their
    widths (the narrowest instantiated width that holds the layer; stacked
    layers at the wider one's) for a width-1 input (any for lstm_last),
    else the general design, one launch in clusters of C blocks (as
    expected_cluster picks) of 4 reads a cluster, each block 4 lanes a
    unit it owns in whole warps (at most 512; in the stacked kernel each
    layer at most 256). Returns (route, [(hidden,
    shape, cluster, rows)])."""
    hiddens = [h for _, h in layers]
    widths = REGISTER_WIDTHS[name]
    padded = [w for w in widths if w >= max(hiddens)]
    if padded and (inputs == 1 or name == 'lstm_last'):
        width = padded[0]
        threads = {'lstm2_stacked': 8, 'bidirectional_lstm': 4,
                   'lstm_last': 2}[name] * width
        return 'register', [(width, (2, threads, -(-batch // 2)), None,
                             None)]
    if name == 'lstm2_stacked':
        h1, h2 = hiddens
        cluster, rows = expected_cluster('lstm2_stacked_general_kernel',
                                         (h1, h2))
        t1, t2 = (warps(-(-h // cluster), 256) for h in (h1, h2))
        return 'general', [((h1, h2), (4, t1 + t2,
                                       -(-batch // 4) * cluster), cluster,
                            rows)]
    directions = 2 if name == 'bidirectional_lstm' else 1
    h = hiddens[0]
    cluster, rows = expected_cluster('lstm_general_kernel', (h,))
    return 'general', [(h, (4, warps(-(-h // cluster), 512),
                            -(-batch // 4) * cluster * directions), cluster,
                        rows)]


# the widened preset's general shapes and one past what 8 blocks hold:
# (case, cluster, rows of each matrix in shared memory)
CLUSTER_CASES = [
    (('lstm2_stacked', 1, ((1, 96), (96, 96))), 2, 96),
    (('lstm_last', 112, ((112, 128),)), 2, 128),
    (('lstm2_stacked', 1, ((1, 256), (256, 256))), 8, 139)]


@pytest.mark.parametrize('case', LSTM_CASES + [
    ('lstm2_stacked', 1, ((1, 48), (48, 48))),
    ('bidirectional_lstm', 1, ((1, 48), (1, 48))),
    ('bidirectional_lstm', 1, ((1, 49), (1, 49))),
    ('bidirectional_lstm', 1, ((1, 64), (1, 64))),
    ('bidirectional_lstm', 1, ((1, 65), (1, 65))),
    ('lstm_last', 96, ((96, 64),)),
    ('lstm_last', 112, ((112, 128),)),
    ('lstm2_stacked', 1, ((1, 40), (40, 24))),
    ('lstm2_stacked', 1, ((1, 256), (256, 256))),
    ('lstm2_stacked', 1, ((1, 96), (96, 96))),
    ('bidirectional_lstm', 3, ((3, 256), (3, 256)))], ids=case_id)
def test_plan_picks_the_design(case):
    name, inputs, layers = case
    hiddens = [h for _, h in layers]
    h2 = hiddens[1] if name == 'lstm2_stacked' else None
    for batch in (1, 37, 256):
        plan = klstm.plan(name, batch, inputs, hiddens[0], h2)
        route, launches = expected_plan(name, inputs, layers, batch)
        assert plan.route == route
        assert [(l.hidden, l.shape, l.cluster, l.smem_rows)
                for l in plan.launches] == launches
        for launch in plan.launches:
            if route != 'general':
                continue
            widths = launch.hidden if isinstance(launch.hidden, tuple) \
                else (launch.hidden,)
            c = launch.cluster
            # each width's unit ranges partition it, contiguous and within
            # one unit of each other
            for h in widths:
                ranges = [klstm.unit_range(h, c, r) for r in range(c)]
                assert ranges[0][0] == 0 and ranges[-1][1] == h
                assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
                sizes = [e - b for b, e in ranges]
                assert max(sizes) - min(sizes) <= 1
            # every block's share, and what is allocated, fits
            assert block_smem(launch.kernel, widths, c, launch.smem_rows) \
                <= klstm.SMEM_BYTES
            assert all(block_smem(launch.kernel, widths, c, launch.smem_rows,
                                  r) <= klstm.SMEM_BYTES for r in range(c))
            # no smaller portable cluster holds every row; if this one
            # does not, it is 8 holding as many rows as fit
            most = max(widths)
            assert all(block_smem(launch.kernel, widths, smaller, most) >
                       klstm.SMEM_BYTES for smaller in CLUSTERS
                       if smaller < c)
            assert launch.smem_rows == most or (c == 8 and block_smem(
                launch.kernel, widths, 8, launch.smem_rows + 1) >
                klstm.SMEM_BYTES)


@pytest.mark.parametrize('case,cluster,rows', CLUSTER_CASES,
                         ids=[case_id(c[0]) for c in CLUSTER_CASES])
def test_plan_clusters_the_wide_layers(case, cluster, rows):
    """LSTM(96) x 2 and LSTM(128) of the widened preset run in clusters
    of 2 blocks that hold every weight row; LSTM(256) x 2 in clusters of
    8 that hold 139 of its 256 rows, the rest read from device memory."""
    name, inputs, layers = case
    hiddens = [h for _, h in layers]
    launch, = klstm.plan(name, 256, inputs, hiddens[0],
                         hiddens[1] if name == 'lstm2_stacked' else None
                         ).launches
    assert (launch.cluster, launch.smem_rows) == (cluster, rows)
    assert launch.shape[2] == 64 * cluster


def block_columns(mat, hidden, first, end):
    """One block's share of mat [R, 4 hidden]: the four gate columns of
    units [first, end), every other column zeroed. The share keeps the
    whole matrix's shape, so that torch.matmul sums each kept column in
    the same order as on the whole matrix."""
    keep = torch.zeros(4, hidden, dtype=mat.dtype)
    keep[:, first:end] = 1
    return mat * keep.reshape(-1)


def blocks_of(hidden, cluster):
    return [klstm.unit_range(hidden, cluster, r) for r in range(cluster)]


def cluster_recurrence(zx, rec, cluster):
    """ops/rnn.recurrence as a cluster of ``cluster`` blocks runs it:
    block r computes the pre-activations of its units from its columns of
    rec and the full h, applies their gates with its own c, and each step
    gathers h from every block's units. Returns the sequence."""
    batch, seqlen, _ = zx.shape
    hidden = rec.shape[0]
    blocks = blocks_of(hidden, cluster)
    cols = [block_columns(rec, hidden, a, b) for a, b in blocks]
    h = zx.new_zeros((batch, hidden))
    cs = [zx.new_zeros((batch, hidden)) for _ in blocks]
    hs = []
    for t in range(seqlen):
        gathered = torch.empty_like(h)
        for r, (a, b) in enumerate(blocks):
            h_r, cs[r] = rnn.lstm_gates(zx[:, t] + torch.matmul(h, cols[r]),
                                        cs[r])
            gathered[:, a:b] = h_r[:, a:b]
        h = gathered
        hs.append(h)
    return torch.stack(hs, 1)


def cluster_stacked(params1, params2, xs, cluster):
    """ops/rnn.lstm2_stacked as a cluster of ``cluster`` blocks runs it on
    the diagonal: in phase p each block computes its layer-1 units' step
    p and its layer-2 units' step p - 1 from its columns of r1, k2 and r2
    and the full h1[p - 1] and h2[p - 2], gathered from every block."""
    zx = rnn.project(params1, xs)
    batch, seqlen, _ = zx.shape
    h1w, h2w = params1['recurrent'].shape[0], params2['recurrent'].shape[0]
    blocks1, blocks2 = blocks_of(h1w, cluster), blocks_of(h2w, cluster)
    r1 = [block_columns(params1['recurrent'], h1w, a, b) for a, b in blocks1]
    k2 = [block_columns(params2['kernel'], h2w, a, b) for a, b in blocks2]
    r2 = [block_columns(params2['recurrent'], h2w, a, b) for a, b in blocks2]
    h1, h2 = zx.new_zeros((batch, h1w)), zx.new_zeros((batch, h2w))
    c1 = [torch.zeros_like(h1) for _ in range(cluster)]
    c2 = [torch.zeros_like(h2) for _ in range(cluster)]
    for p in range(seqlen + 1):
        n1, n2 = torch.empty_like(h1), torch.empty_like(h2)
        for r in range(cluster):
            if p < seqlen:
                g, c1[r] = rnn.lstm_gates(
                    zx[:, p] + torch.matmul(h1, r1[r]), c1[r])
                a, b = blocks1[r]
                n1[:, a:b] = g[:, a:b]
            if p > 0:
                g, c2[r] = rnn.lstm_gates(
                    torch.matmul(h1, k2[r]) + params2['bias'] +
                    torch.matmul(h2, r2[r]), c2[r])
                a, b = blocks2[r]
                n2[:, a:b] = g[:, a:b]
        h1 = n1 if p < seqlen else h1
        h2 = n2 if p > 0 else h2
    return h2


# (wrapper, input width, widths, cluster: None for the plan's)
PARTITION_CASES = [
    ('lstm_last', 3, (128,), None), ('bidirectional_lstm', 3, (96,), None),
    ('lstm2_stacked', 1, (96, 96), None),
    ('lstm2_stacked', 1, (256, 256), None),
    ('lstm_last', 3, (20,), 1), ('lstm_last', 3, (20,), 2),
    ('lstm_last', 3, (20,), 4), ('lstm_last', 3, (20,), 8),
    ('lstm2_stacked', 3, (40, 24), 8), ('lstm2_stacked', 1, (32, 96), 4),
    ('lstm2_stacked', 3, (3, 20), 8)]


@pytest.mark.parametrize('name,inputs,widths,cluster', PARTITION_CASES,
                         ids=['{}-I{}-H{}-C{}'.format(n, i, '-'.join(
                             map(str, w)), c) for n, i, w, c in
                             PARTITION_CASES])
def test_cluster_partition_changes_no_sum(name, inputs, widths, cluster):
    """The general kernels' split of a layer's units over the blocks of a
    cluster, modelled in plain PyTorch (each block's units from its own
    weight columns and the full h, gathered every step), equals
    ops/rnn.py exactly: the split alone changes no sum."""
    rng = np.random.RandomState(sum(widths) + inputs)
    xs = torch.from_numpy(rng.normal(0, 1, (3, 12, inputs)).astype(
        np.float32))
    if cluster is None:
        launch, = klstm.plan(name, 3, inputs, *widths).launches \
            if name == 'lstm2_stacked' else \
            klstm.plan(name, 3, inputs, widths[0]).launches
        cluster = launch.cluster
    if name == 'lstm2_stacked':
        p1 = as_torch(random_layer(rng, inputs, widths[0]))
        p2 = as_torch(random_layer(rng, widths[0], widths[1]))
        got = cluster_stacked(p1, p2, xs, cluster)
        want = rnn.lstm2_stacked(p1, p2, xs)
    else:
        p = as_torch(random_layer(rng, inputs, widths[0]))
        got = cluster_recurrence(rnn.project(p, xs), p['recurrent'], cluster)
        want = rnn.recurrence(rnn.project(p, xs), p['recurrent'])
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_shipped_shapes_keep_their_kernels():
    """The scaler, BiLSTM and LSTM(64) of the shipped networks run on the
    register kernels at their own widths, unpadded; so does the widened
    preset's BiLSTM(56)."""
    assert klstm.plan('lstm2_stacked', 256, 1, 48, 48).launches[0][:2] == \
        ('lstm2_stacked_kernel', 48)
    assert klstm.plan('bidirectional_lstm', 256, 1, 48).launches[0][:2] == \
        ('bilstm_kernel', 48)
    assert klstm.plan('lstm_last', 256, 96, 64).launches[0][:2] == \
        ('lstm_last_kernel', 64)
    assert klstm.plan('bidirectional_lstm', 256, 1,
                      simulate.WIDENED_SEQ_HIDDEN).launches[0][:3] == \
        ('bilstm_kernel', 56, (2, 224, 128))


@pytest.mark.parametrize('hidden', (20, 48, 49, 52, 56, 57, 64))
def test_bilstm_kernel_takes_the_layer_unpadded(hidden, monkeypatch):
    """A BiLSTM of up to 64 units with a width-1 input reaches its kernel
    with the caller's own weight tensors (no padded copy) and an output
    of [B, T, 2H], no column past 2H (no copy after the launch): the
    tensors the wrapper hands to the launch, caught on 'meta' tensors,
    which stop it there."""
    seen = []

    def require_cuda(name, *tensors):
        seen.append(tensors)
        raise ValueError('no kernel for device meta')
    monkeypatch.setattr(_build, 'require_cuda', require_cuda)
    fwd, bwd = meta_layer(1, hidden), meta_layer(1, hidden)
    xs = torch.empty(3, 5, 1, device='meta')
    with pytest.raises(ValueError, match='no kernel for device meta'):
        klstm.bidirectional_lstm(fwd, bwd, xs)
    (tensors,) = seen
    assert tensors[0] is xs
    assert all(got is want for got, want in zip(tensors[1:7], [
        p[key] for p in (fwd, bwd)
        for key in ('kernel', 'bias', 'recurrent')]))
    assert tuple(tensors[7].shape) == (3, 5, 2 * hidden)


def meta_layer(inputs, hidden):
    meta = dict(device='meta', dtype=torch.float32)
    return {'kernel': torch.empty(inputs, 4 * hidden, **meta),
            'recurrent': torch.empty(hidden, 4 * hidden, **meta),
            'bias': torch.empty(4 * hidden, **meta)}


@pytest.mark.parametrize('case', LSTM_CASES, ids=case_id)
def test_lstm_wrappers_accept_every_shape(case):
    """Every shape passes the wrapper's checks, its padding and input
    product, up to the launch: a 'meta' tensor, which no kernel takes,
    stops it there."""
    name, inputs, layers = case
    xs = torch.empty(3, 5, inputs, device='meta')
    with pytest.raises(ValueError, match='no kernel for device meta'):
        getattr(klstm, name)(*[meta_layer(i, h) for i, h in layers], xs)


def test_inert_units_add_nothing():
    """The register design's padding: the plain LSTMs on layers padded
    with inert units (zero kernel, recurrent and bias entries, and zero
    input rows for the padded units below) give the unpadded results."""
    rng = np.random.RandomState(3)
    xs = torch.from_numpy(rng.normal(0, 1, (3, 40, 1)).astype(np.float32))
    p1, p2 = (as_torch(random_layer(rng, 1, 40)),
              as_torch(random_layer(rng, 40, 24)))
    k1, b1, r1 = klstm._pad_layer(p1, 1, 48)
    k2, b2, r2 = klstm._pad_layer(p2, 48, 48)
    padded = rnn.lstm2_stacked(
        {'kernel': k1, 'bias': b1, 'recurrent': r1},
        {'kernel': k2, 'bias': b2, 'recurrent': r2}, xs)
    np.testing.assert_allclose(padded[:, :24].numpy(),
                               rnn.lstm2_stacked(p1, p2, xs).numpy(),
                               atol=1e-6)
    assert not padded[:, 24:].any()

    fwd, bwd = (as_torch(random_layer(rng, 1, 56)) for _ in range(2))
    seq = rnn.bidirectional_lstm(
        dict(zip(('kernel', 'bias', 'recurrent'),
                 klstm._pad_layer(fwd, 1, 64))),
        dict(zip(('kernel', 'bias', 'recurrent'),
                 klstm._pad_layer(bwd, 1, 64))), xs)
    want = rnn.bidirectional_lstm(fwd, bwd, xs)
    np.testing.assert_allclose(
        torch.cat([seq[..., :56], seq[..., 64:120]], dim=-1).numpy(),
        want.numpy(), atol=1e-6)
    assert not seq[..., 56:64].any() and not seq[..., 120:].any()


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match='shared memory'):
        klstm.plan('lstm_last', 4, 3, 20000)
    with pytest.raises(ValueError, match='no LSTM wrapper'):
        klstm.plan('lstm', 4, 3, 20)
    with pytest.raises(ValueError, match='empty'):
        klstm.plan('lstm_last', 0, 3, 20)


# ---------------------------------------------------------------- Viterbi

def viterbi_case(nstates, ncomp, tie=False):
    """The HMM's arrays and 5 reads of 150 frames of its signal; the tie
    HMM's reads dwell on its tied states' level first."""
    rng = np.random.default_rng(100 * nstates + ncomp + 1000 * tie)
    arrays = (simulate.tie_hmm(ncomp, nstates) if tie else
              simulate.random_hmm(rng, nstates, ncomp))
    x, lengths = simulate.hmm_signal(rng, arrays[2], 5, 150)
    if tie:
        x[:, :40] = arrays[2][1, 0] + rng.normal(0, 3.0, (5, 40))
    return arrays, x, lengths


VITERBI_CASES = [(s, k, False) for s in STATES for k in COMPONENTS] + \
    [(s, k, True) for s in (7, 8) for k in (1, 3)]


@pytest.mark.parametrize('nstates,ncomp,tie', VITERBI_CASES)
def test_plain_viterbi_matches_pallas(nstates, ncomp, tie):
    arrays, x, lengths = viterbi_case(nstates, ncomp, tie)
    params = [torch.from_numpy(a) for a in arrays]
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)

    before = dict(kernels.launches)
    path, logp = kvit.viterbi(xt, lt, *params)
    first, last, present, logp2 = kvit.viterbi_extents(xt, lt, *params)
    assert kernels.launches == before      # CPU tensors: plain version
    np.testing.assert_array_equal(logp2.numpy(), logp.numpy())

    jparams = [jnp.asarray(a) for a in arrays]
    jpath, jlogp = pallas_viterbi.viterbi(jnp.asarray(x), jnp.asarray(lengths),
                                          *jparams, interpret=True)
    jf, jl, jp, jlogp2 = pallas_viterbi.viterbi_extents(
        jnp.asarray(x), jnp.asarray(lengths), *jparams, interpret=True)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(present.numpy(), np.asarray(jp))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp),
                               rtol=LOGP_RTOL, atol=0)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp2),
                               rtol=LOGP_RTOL, atol=0)
    if tie:
        assert not (path == 2).any() and (path == 1).any()


def expected_viterbi_plan(nstates, ncomp, batch):
    """States pad to the 6- or 8-state kernels, 1 to 4 components have
    their own instantiations and more the loop over K (0); the shipped
    HMMs' <6,1> and <6,2> keep their design, every other instantiation
    runs the general one; a block is 2 reads, one chain warp and four
    worker warps; the loop's dynamic shared memory, at most 192 KB, holds
    the real states' parameters (mu, sigma, the constant, [nstates, K])
    if they take at most 96 KB, and a scratch of as many components a
    worker (128) as the rest holds, up to K. Returns (states, components,
    design, launch, smem bytes)."""
    states = 6 if nstates <= 6 else 8
    components = ncomp if ncomp <= 4 else 0
    design = 'shipped' if (states, components) in ((6, 1), (6, 2)) else \
        'general'
    smem = 0
    if components == 0:
        params = 3 * nstates * ncomp if 12 * nstates * ncomp <= 96 * 1024 \
            else 0
        keep = min(ncomp, (48 * 1024 - params) // 128)
        smem = 4 * (params + 128 * keep)
    return states, components, design, (2, 160, -(-batch // 2)), smem


@pytest.mark.parametrize('nstates', range(1, 10))
@pytest.mark.parametrize('ncomp', (1, 2, 3, 4, 5, 200))
def test_viterbi_plan_and_wrappers(nstates, ncomp):
    """plan() names the instantiation and its launch (expected_viterbi_plan);
    on 'meta' tensors the wrappers take every shape up to the launch, and
    refuse 9 states before it."""
    meta = dict(device='meta', dtype=torch.float32)
    params = [torch.empty(nstates, **meta),
              torch.empty(nstates, nstates, **meta)] + \
        [torch.empty(nstates, ncomp, **meta) for _ in range(3)]
    x = torch.empty(37, 99, **meta)
    lengths = torch.empty(37, dtype=torch.int32, device='meta')
    if nstates > 8:
        with pytest.raises(ValueError, match='states'):
            kvit.plan(nstates, ncomp, 37)
        for entry in (kvit.viterbi, kvit.viterbi_extents):
            with pytest.raises(ValueError, match='9 states'):
                entry(x, lengths, *params)
        return
    plan = kvit.plan(nstates, ncomp, 37)
    assert tuple(plan) == expected_viterbi_plan(nstates, ncomp, 37)
    assert kvit.function('viterbi_path_kernel', plan) == \
        'viterbi_path_kernel<{},{}>'.format(plan.states, plan.components)
    for entry in (kvit.viterbi, kvit.viterbi_extents):
        with pytest.raises(ValueError, match='no kernel for device meta'):
            entry(x, lengths, *params)


@pytest.mark.parametrize('nstates', (3, 8))
def test_viterbi_plan_bounds_the_loop_over_components(nstates):
    """The loop over K takes any number of components within a bounded
    dynamic shared memory: past the 48 KB a block has by default and
    within the 227 KB it may have, every component kept at 200, part of
    them at 600 (3 states), the parameters left in device memory at 1,100
    (8 states); a million components plan, and reach the launch on 'meta'
    tensors."""
    for ncomp in (200, 600, 1100, 10 ** 6):
        plan = kvit.plan(nstates, ncomp, 1024)
        assert tuple(plan) == expected_viterbi_plan(nstates, ncomp, 1024)
        assert plan.smem <= kvit.DYN_BYTES < 227 * 1024
        params, keep = kvit.any_k(nstates, ncomp)
        assert plan.smem == 4 * (params + keep * kvit.WORKERS)
        assert (params > 0) == (12 * nstates * ncomp <= 96 * 1024)
        if ncomp <= 1100:
            assert plan.smem > 48 * 1024
    assert kvit.any_k(nstates, 200) == (3 * nstates * 200, 200)
    if nstates == 3:
        assert kvit.any_k(3, 600) == (5400, (48 * 1024 - 5400) // 128)
    else:
        assert kvit.any_k(8, 1100) == (0, 384)
    meta = dict(device='meta', dtype=torch.float32)
    params = [torch.empty(nstates, **meta),
              torch.empty(nstates, nstates, **meta)] + \
        [torch.empty(nstates, 10 ** 6, **meta) for _ in range(3)]
    for entry in (kvit.viterbi, kvit.viterbi_extents):
        with pytest.raises(ValueError, match='no kernel for device meta'):
            entry(torch.empty(4, 9, **meta),
                  torch.empty(4, dtype=torch.int32, device='meta'), *params)


# ------------------------------------------------------------- the build

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119viterbi_path_kernelILi8ELi0EEEvPKfPKiS2_S2_NS_7MixtureEPiPxPfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119viterbi_path_kernelILi8ELi0EEEvPKfPKiS2_S2_NS_7MixtureEPiPxPfii
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 360 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119lstm_general_kernelILb1EEEvNS_12GeneralLayerES1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119lstm_general_kernelILb1EEEvNS_12GeneralLayerES1_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12peaks_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z12peaks_kernelPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 360 bytes cmem[0]
"""


def test_ptxas_report_by_instantiation():
    """The resource report of -Xptxas -v, read by kernel and template
    arguments: what kernel_sass.py --lstm-widths reads spills from."""
    assert _build.ptxas_usage(PTXAS) == {
        'viterbi_path_kernel<8,0>': (72, 8, 4, 12),
        'lstm_general_kernel<true>': (64, 0, 0, 0),
        'peaks_kernel': (40, 0, 0, 0)}


# cuobjdump -sass of two Viterbi instantiations, in its layout, with loops
# cut from the card's listing of viterbi_path_kernel<8,3>: the chain's
# forward steps (maxima of scores from shared memory), its backtrace steps
# (a funnel shift and a mask of words in shared memory), a worker's
# emission loop (special functions) and its word loop (a float compare, a
# store to device memory). The second holds a branch in its forward loop
# and a call in its backtrace loop.
STEP_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_119viterbi_path_kernelILi8ELi3EEEvPKfPKiS2_S2_NS_7MixtureEPiPxPfii
        /*0000*/                   LDS R28, [R8] ;                  /* 0x0 */
        /*0010*/                   FADD R12, R4, R12 ;              /* 0x0 */
        /*0020*/                   FMNMX R12, R12, R13, !PT ;       /* 0x0 */
        /*0030*/              @!P1 FADD R25, R15, R28 ;             /* 0x0 */
        /*0040*/              @!P0 STS [R10], R25 ;                 /* 0x0 */
        /*0050*/                   NOP ;                            /* 0x0 */
        /*0060*/                   LDS.128 R12, [R9] ;              /* 0x0 */
        /*0070*/               @P2 BRA 0x0 ;                        /* 0x0 */
        /*0080*/                   MUFU.RCP R3, R2 ;                /* 0x0 */
        /*0090*/                   MUFU.EX2 R4, R3 ;                /* 0x0 */
        /*00a0*/                   FMNMX R5, R4, R3, !PT ;          /* 0x0 */
        /*00b0*/                   STS [R6], R5 ;                   /* 0x0 */
        /*00c0*/               @P3 BRA 0x80 ;                       /* 0x0 */
        /*00d0*/                   LDS.128 R12, [R9] ;              /* 0x0 */
        /*00e0*/                   FMNMX R5, R12, R13, !PT ;        /* 0x0 */
        /*00f0*/                   FSETP.EQ.AND P0, PT, R12, R5, PT ; /* 0x0 */
        /*0100*/                   SHFL.BFLY PT, R7, R6, 0x1, 0x1f ; /* 0x0 */
        /*0110*/                   STG.E desc[UR4][R2.64], R7 ;     /* 0x0 */
        /*0120*/               @P4 BRA 0xd0 ;                       /* 0x0 */
        /*0130*/                   LDS.128 R4, [R3] ;               /* 0x0 */
        /*0140*/                   SHF.R.W.U32.HI R9, R7, R0, R7 ;  /* 0x0 */
        /*0150*/                   LOP3.LUT R0, R9, 0x1c, RZ, 0xc0, !PT ; /* 0x0 */
        /*0160*/              @!P0 STS [R2+0xc], R0 ;               /* 0x0 */
        /*0170*/               @P5 BRA 0x130 ;                      /* 0x0 */
        /*0180*/                   EXIT ;                           /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_122viterbi_extents_kernelILi6ELi2EEEvPKfPKiS2_S2_NS_7MixtureEPiPxS5_Pfii
        /*0000*/                   LDS.128 R12, [R9] ;              /* 0x0 */
        /*0010*/                   FMNMX R12, R12, R13, !PT ;       /* 0x0 */
        /*0020*/               @P0 BRA 0x40 ;                       /* 0x0 */
        /*0030*/                   STS [R10], R12 ;                 /* 0x0 */
        /*0040*/               @P2 BRA 0x0 ;                        /* 0x0 */
        /*0050*/                   LDS.128 R4, [R3] ;               /* 0x0 */
        /*0060*/                   SHF.R.S32.HI R9, RZ, R0, R7 ;    /* 0x0 */
        /*0070*/                   LOP3.LUT R0, R9, 0x1f, RZ, 0xc0, !PT ; /* 0x0 */
        /*0080*/              @!P1 CALL.REL.NOINC 0x100 ;           /* 0x0 */
        /*0090*/                   STS [R2], R0 ;                   /* 0x0 */
        /*00a0*/               @P5 BRA 0x50 ;                       /* 0x0 */
        /*00b0*/                   EXIT ;                           /* 0x0 */
\t\tFunction : _Z12peaks_kernelPKf
        /*0000*/                   FMNMX R1, R2, R3, !PT ;          /* 0x0 */
        /*0010*/                   STS [R4], R1 ;                   /* 0x0 */
        /*0020*/               @P0 BRA 0x0 ;                        /* 0x0 */
"""


def test_viterbi_step_loops_by_instantiation():
    """kernel_sass.py finds each Viterbi instantiation's forward and
    backtrace step loops (and no worker loop among them, and no other
    kernel), and flags an instantiation whose step loops hold a branch
    besides the back edge or a call."""
    import kernel_sass
    found = kernel_sass.step_loops(STEP_SASS)
    assert sorted(found) == ['viterbi_extents_kernel<6,2>',
                             'viterbi_path_kernel<8,3>']
    clean = found['viterbi_path_kernel<8,3>']
    assert [(l['first'], l['last']) for l in clean['forward']] == \
        [('0x0', '0x70')]
    assert [(l['first'], l['last']) for l in clean['backtrace']] == \
        [('0x130', '0x170')]
    assert all(l['inner_branches'] == 0 and l['calls'] == 0
               for loops in clean.values() for l in loops)
    faulty = found['viterbi_extents_kernel<6,2>']
    assert [(l['inner_branches'], l['calls']) for l in faulty['forward']] == \
        [(1, 0)]
    assert [(l['inner_branches'], l['calls'])
            for l in faulty['backtrace']] == [(0, 1)]
    assert kernel_sass.unclean_step_loops(found) == \
        ['viterbi_extents_kernel<6,2>']
    # a listing without a backtrace loop is not clean either
    no_back = STEP_SASS[:STEP_SASS.index('        /*0130*/')]
    assert kernel_sass.unclean_step_loops(kernel_sass.step_loops(no_back)) \
        == ['viterbi_path_kernel<8,3>']


def test_viterbi_register_limit():
    """Four blocks of 160 threads an SM leave a thread 102 of the SM's
    65,536 registers, 96 at the allocation unit of 8: the general design
    must stay within it (kernel_sass.py) so that the 512 blocks of 1,024
    windows run in one wave, as the shipped <6,2> (78 and 94) does."""
    import kernel_sass
    assert kvit.THREADS == 160
    assert kernel_sass.viterbi_register_limit() == 96
    assert kernel_sass.viterbi_register_limit(blocks=1) == 408
