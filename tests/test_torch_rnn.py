"""poreplex_torch LSTMs vs the JAX package's: the XLA scans of
poreplex_tpu.ops.rnn, the Pallas kernels in interpret mode, and the
TensorFlow goldens of the scaler and demux networks. Tolerance 5e-5
absolute, the bound PARITY.md and tests/test_rnn.py use. The CUDA kernels
do not run here; chip_smoke.py holds them against these plain versions on
the card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from poreplex_tpu.ops import rnn as jrnn, pallas_rnn
from poreplex_torch import kernels
from poreplex_torch.kernels import lstm as klstm
from poreplex_torch.models.demux import DemuxModel
from poreplex_torch.models.scaler import ScalerModel
from poreplex_torch.ops import rnn

ATOL = 5e-5


def random_params(rng, inputs, hidden):
    return {
        'kernel': rng.normal(0, 0.3, (inputs, 4 * hidden)).astype(np.float32),
        'recurrent': rng.normal(0, 0.3, (hidden, 4 * hidden)).astype(
            np.float32),
        'bias': rng.normal(0, 0.1, (4 * hidden,)).astype(np.float32),
    }


def as_jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def as_torch(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def jax_lstm_last(p, xs):
    return jrnn.lstm(p, xs, return_sequences=False, unroll=1)


# (name, port function, JAX XLA function, Pallas function, layer shapes,
#  input width)
CASES = {
    'lstm2_stacked': (klstm.lstm2_stacked,
                      lambda p1, p2, xs: jrnn.lstm2_stacked(p1, p2, xs,
                                                            unroll=1),
                      pallas_rnn.lstm2_stacked_pallas,
                      [(1, 48), (48, 48)], 1),
    'bidirectional_lstm': (klstm.bidirectional_lstm,
                           lambda pf, pb, xs: jrnn.bidirectional_lstm(
                               pf, pb, xs, unroll=1),
                           pallas_rnn.bidirectional_lstm_pallas,
                           [(1, 48), (1, 48)], 1),
    'lstm_last': (klstm.lstm_last, jax_lstm_last,
                  pallas_rnn.lstm_last_pallas, [(96, 64)], 96),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_port_matches_xla_and_pallas(name):
    port, xla, pallas, shapes, inputs = CASES[name]
    rng = np.random.RandomState(7)
    params = [random_params(rng, i, h) for i, h in shapes]
    xs = rng.normal(0, 1, (4, 100, inputs)).astype(np.float32)

    before = dict(kernels.launches)
    got = port(*[as_torch(p) for p in params], torch.from_numpy(xs)).numpy()
    assert kernels.launches == before      # CPU tensors: plain version

    ref_xla = np.asarray(xla(*[as_jax(p) for p in params], jnp.asarray(xs)))
    ref_pallas = np.asarray(pallas(*[as_jax(p) for p in params],
                                   jnp.asarray(xs), interpret=True))
    assert got.shape == ref_xla.shape
    np.testing.assert_allclose(got, ref_xla, atol=ATOL)
    np.testing.assert_allclose(got, ref_pallas, atol=ATOL)


def test_width1_projection_is_two_roundings():
    """rnn.project at input width 1 is x * kernel rounded, then + bias
    rounded: the arithmetic the scaler kernel repeats in place of the GEMM,
    so its zx is bit-identical."""
    rng = np.random.RandomState(9)
    p = random_params(rng, 1, 48)
    xs = rng.normal(90, 12, (3, 50, 1)).astype(np.float32)
    got = rnn.project(as_torch(p), torch.from_numpy(xs)).numpy()
    want = (xs * p['kernel'][0]) + p['bias']
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_stacked_kernel_takes_width_one_only():
    """The scaler's register kernel folds a width-1 projection; a wider
    input goes to the general design, whose input product is one matmul:
    the wrapper accepts it and runs it up to the launch (a 'meta' tensor
    stands for the card's and stops it there)."""
    meta = dict(device='meta', dtype=torch.float32)
    p1 = {'kernel': torch.empty(2, 192, **meta),
          'recurrent': torch.empty(48, 192, **meta),
          'bias': torch.empty(192, **meta)}
    p2 = {'kernel': torch.empty(48, 192, **meta),
          'recurrent': torch.empty(48, 192, **meta),
          'bias': torch.empty(192, **meta)}
    assert klstm.plan('lstm2_stacked', 2, 1, 48, 48).launches[0].kernel == \
        'lstm2_stacked_kernel'
    plan = klstm.plan('lstm2_stacked', 2, 2, 48, 48)
    assert plan.route == 'general'
    assert [launch.kernel for launch in plan.launches] == \
        ['lstm2_stacked_general_kernel']       # both layers in one launch
    with pytest.raises(ValueError, match='no kernel for device meta'):
        klstm.lstm2_stacked(p1, p2, torch.empty(2, 5, 2, **meta))


def test_bilstm_kernel_takes_width_one_only():
    """The BiLSTM's register kernel folds a width-1 projection of both
    directions; a wider input goes to the general design (both directions
    in one launch): the wrapper accepts it and runs it up to the launch (a
    'meta' tensor stands for the card's)."""
    meta = dict(device='meta', dtype=torch.float32)
    p = {'kernel': torch.empty(3, 192, **meta),
         'recurrent': torch.empty(48, 192, **meta),
         'bias': torch.empty(192, **meta)}
    assert klstm.plan('bidirectional_lstm', 2, 1, 48).route == 'register'
    plan = klstm.plan('bidirectional_lstm', 2, 3, 48)
    assert plan.route == 'general'
    assert plan.launches[0].shape == (4, 192, 2)    # a block per direction
    with pytest.raises(ValueError, match='no kernel for device meta'):
        klstm.bidirectional_lstm(p, p, torch.empty(2, 5, 3, **meta))


def test_reverse_lstm_matches_xla():
    rng = np.random.RandomState(8)
    p = random_params(rng, 3, 16)
    xs = rng.normal(0, 1, (2, 40, 3)).astype(np.float32)
    got = rnn.lstm(as_torch(p), torch.from_numpy(xs), reverse=True).numpy()
    ref = np.asarray(jrnn.lstm(as_jax(p), jnp.asarray(xs), reverse=True,
                               unroll=1))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_scaler_forward_matches_tf(nn_goldens, scaler_model_path):
    model = ScalerModel(scaler_model_path, device='cpu')
    heads = torch.from_numpy(nn_goldens['scaler_in'])
    h = klstm.lstm2_stacked(model.lstm1, model.lstm2, heads[..., None])
    pred = rnn.dense(model.dense, h).detach().numpy()
    np.testing.assert_allclose(pred, nn_goldens['scaler_out'], atol=ATOL)


def test_demux_forward_matches_tf(nn_goldens, demux_model_path):
    model = DemuxModel(demux_model_path, device='cpu')
    with torch.inference_mode():
        probs = model(torch.from_numpy(nn_goldens['demux_in'])).numpy()
    np.testing.assert_allclose(probs, nn_goldens['demux_out'], atol=ATOL)
