"""poreplex_torch Viterbi and segment extents vs the JAX package's XLA op
(poreplex_tpu.ops.viterbi) and its Pallas extents kernel in interpret
mode: paths and extents exactly equal, logp within 1e-5 relative. The CUDA
kernel does not run here; chip_smoke.py holds it against this plain
version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreplex_tpu.config import load_preset
from poreplex_tpu.models.segmentation import SegmentationHMM as JaxHMM
from poreplex_tpu.ops import viterbi as jvit, pallas_viterbi
from poreplex_torch import kernels
from poreplex_torch.kernels import viterbi as kvit
from poreplex_torch.models.segmentation import SegmentationHMM
from poreplex_torch.ops import viterbi as vit
from poreplex_torch.simulate import tie_hmm

LOGP_RTOL = 1e-5


@pytest.fixture(scope='module')
def spec():
    return load_preset()['segmentation_model']


def synth_signal(rng, layout):
    return np.concatenate(
        [rng.normal(mu, sd, n) for mu, sd, n in layout]).astype(np.float32)


def batch(seed, B, T, second_adapter):
    """B reads of HMM-like signal with lengths up to T; a second
    adapter-level block exercises last-run extents."""
    rng = np.random.RandomState(seed)
    x = np.full((B, T), 96.0, np.float32)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        L = int(rng.randint(40, T + 1))
        layout = [(71.5, 3.7, int(L * .05)), (102.1, 3.9, int(L * .05)),
                  (112.0, 4.8, int(L * .05)), (80.5, 7.4, int(L * .3)),
                  (108.95, 2.5, int(L * .1))]
        if second_adapter:
            layout.append((80.5, 7.4, int(L * .1)))
        layout.append((96.0, 11.0, L - sum(p[2] for p in layout)))
        x[i, :L] = synth_signal(rng, layout)
        lens[i] = L
    return x, lens


def port_params(model):
    return model.params()


@pytest.mark.parametrize('seed,B,T,second_adapter',
                         [(17, 4, 160, False), (23, 6, 180, True),
                          (29, 8, 512, True)])
def test_extents_match_xla_and_pallas(spec, seed, B, T, second_adapter):
    x, lens = batch(seed, B, T, second_adapter)
    m = SegmentationHMM(spec, device='cpu')
    jm = JaxHMM(spec)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)

    path, logp = vit.viterbi(xt, lt, *port_params(m))
    first, last, present = vit.segment_extents(path, lt, m.nstates)

    jpath, jlogp = jax.jit(lambda a, b: jvit.viterbi(
        a, b, jm.log_start, jm.log_trans, jm.mus, jm.sigmas, jm.logws))(
            x, lens)
    jf, jl, jp = jvit.segment_extents(jpath, jnp.asarray(lens), jm.nstates)
    pf, pl, pp, plogp = pallas_viterbi.viterbi_extents(
        jnp.asarray(x), jnp.asarray(lens), jm.log_start, jm.log_trans,
        jm.mus, jm.sigmas, jm.logws, interpret=True)

    jpath = np.asarray(jpath)
    for i in range(B):
        np.testing.assert_array_equal(path[i, :lens[i]].numpy(),
                                      jpath[i, :lens[i]])
    for ref in ((jf, jl, jp), (pf, pl, pp)):
        np.testing.assert_array_equal(first.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(last.numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(present.numpy(), np.asarray(ref[2]))
    for ref in (jlogp, plogp):
        np.testing.assert_allclose(logp.numpy(), np.asarray(ref),
                                   rtol=LOGP_RTOL)

    before = dict(kernels.launches)
    kf, kl, kp, klogp = kvit.viterbi_extents(xt, lt, *port_params(m))
    assert kernels.launches == before      # CPU tensors: plain version
    np.testing.assert_array_equal(kf.numpy(), first.numpy())
    np.testing.assert_array_equal(kl.numpy(), last.numpy())
    np.testing.assert_array_equal(kp.numpy(), present.numpy())
    np.testing.assert_array_equal(klogp.numpy(), logp.numpy())


def test_tiebreak_first_occurrence():
    """States 0 and 1 tie exactly at t=0 and reach state 2 at equal cost:
    the lower index wins, as in tests/test_reference_c_parity.py."""
    log_start = np.log(np.array([0.5, 0.5, 1e-12]))
    log_trans = np.log(np.array([[0.4, 0.3, 0.3],
                                 [0.3, 0.4, 0.3],
                                 [0.1, 0.1, 0.8]]))
    mus = np.array([[0.0], [0.0], [5.0]])
    sigmas = np.ones((3, 1))
    logws = np.zeros((3, 1))
    obs = np.array([[0.0, 5.0, 5.0]], np.float32)
    args = [torch.tensor(a, dtype=torch.float32)
            for a in (log_start, log_trans, mus, sigmas, logws)]
    path, logp = vit.viterbi(torch.from_numpy(obs), torch.tensor([3]), *args)
    jpath, jlogp = jvit.viterbi(jnp.asarray(obs), jnp.asarray([3]),
                                *[jnp.asarray(a, jnp.float32) for a in
                                  (log_start, log_trans, mus, sigmas,
                                   logws)])
    assert path[0, 0] == 0
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp),
                               rtol=LOGP_RTOL)


def level_signal(seed, B, T, levels, runlen=20):
    """B reads of runs of runlen frames at the given levels plus noise,
    with lengths 1, T and then random ones."""
    rng = np.random.default_rng(seed)
    lv = rng.choice(levels, (B, T // runlen + 1))
    x = (np.repeat(lv, runlen, axis=1)[:, :T] +
         rng.normal(0, 3.0, (B, T))).astype(np.float32)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[:2] = (1, T)
    return x, lens


def check_three_ways(entry, x, lens, params):
    """The port's entry (its plain version, on CPU tensors) against the
    XLA op and the Pallas kernel in interpret mode: paths within each
    read's length (the XLA op's also past it) and extents exactly equal,
    logp within LOGP_RTOL. Returns the port's path."""
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    targs = [torch.from_numpy(a) for a in params]
    jargs = [jnp.asarray(a) for a in params]
    before = dict(kernels.launches)
    got = getattr(kvit, entry)(xt, lt, *targs)
    assert kernels.launches == before      # CPU tensors: plain version
    path, logp = vit.viterbi(xt, lt, *targs)
    jpath, jlogp = jvit.viterbi(jnp.asarray(x), jnp.asarray(lens), *jargs)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    pallas = getattr(pallas_viterbi, entry)(jnp.asarray(x), jnp.asarray(lens),
                                            *jargs, interpret=True)
    if entry == 'viterbi':
        np.testing.assert_array_equal(got[0].numpy(), path.numpy())
        ppath = np.asarray(pallas[0])
        for i in range(len(lens)):
            np.testing.assert_array_equal(path[i, :lens[i]].numpy(),
                                          ppath[i, :lens[i]])
    else:
        nstates = params[0].shape[0]
        ref = vit.segment_extents(path, lt, nstates)
        jref = jvit.segment_extents(jpath, jnp.asarray(lens), nstates)
        for a, b, c, d in zip(got[:3], ref, jref, pallas[:3]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
            np.testing.assert_array_equal(a.numpy(), np.asarray(d))
    np.testing.assert_array_equal(got[-1].numpy(), logp.numpy())
    for ref in (jlogp, pallas[-1]):
        np.testing.assert_allclose(logp.numpy(), np.asarray(ref),
                                   rtol=LOGP_RTOL)
    return path


@pytest.mark.parametrize('entry', ['viterbi_extents', 'viterbi'])
@pytest.mark.parametrize('ncomp', [1, 2])
def test_tie_case_matches_xla_and_pallas(entry, ncomp):
    """Argmax ties between states 1 and 2 on every frame at their level:
    all three decodes agree exactly and the lower state always wins."""
    params = tie_hmm(ncomp)
    x, lens = level_signal(31 + ncomp, 5, 150, params[2][:, 0])
    path = check_three_ways(entry, x, lens, params)
    inside = torch.arange(x.shape[1])[None, :] < torch.from_numpy(lens)[:, None]
    assert not bool((path == 2).any())
    assert bool(((path == 1) & inside).any())


@pytest.mark.parametrize('entry', ['viterbi_extents', 'viterbi'])
@pytest.mark.parametrize('seqlen', [63, 130])
def test_lengths_off_the_tile(spec, entry, seqlen):
    """Sequence lengths that are not a multiple of the CUDA kernels' tile
    of 64 frames, with reads of length 1 and of the whole length."""
    m = SegmentationHMM(spec, device='cpu')
    params = [t.numpy() for t in port_params(m)]
    x, lens = level_signal(seqlen, 6, seqlen,
                           [71.5, 102.1, 112.0, 80.5, 108.95, 96.0], 9)
    check_three_ways(entry, x, lens, params)


def test_padding_does_not_change_result(spec):
    m = SegmentationHMM(spec, device='cpu')
    rng = np.random.RandomState(4)
    sig = synth_signal(rng, [(71.5, 3.7, 30), (102.1, 3.9, 20),
                             (112.0, 4.8, 10), (80.5, 7.4, 100),
                             (108.95, 2.5, 50), (96.0, 11.0, 80)])
    L = len(sig)
    x2 = np.zeros((1, L + 173), np.float32)
    x2[0, :L] = sig
    p1, lp1, f1, l1, _ = m.decode(sig[None, :], np.array([L]))
    p2, lp2, f2, l2, _ = m.decode(x2, np.array([L]))
    np.testing.assert_array_equal(p1[0, :L], p2[0, :L])
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(l1, l2)
    assert lp1[0] == lp2[0]
