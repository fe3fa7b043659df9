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
