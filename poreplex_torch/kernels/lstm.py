"""Wrappers of the LSTM recurrence kernels (``csrc/lstm.cu``).

Same signatures and results as the plain versions in ``ops/rnn.py``, which
run for CPU tensors. For CUDA tensors each is one kernel launch. The
width-1 input projections of the scaler and of the demultiplexer's BiLSTM
are folded into their kernels whole; the LSTM(64)'s input product is one
``torch.matmul`` (hoisted out of the recurrence, as in the JAX package),
and its kernel adds the bias itself:

  lstm2_stacked       scaler LSTM(48) -> LSTM(48), last h      [B, 48]
  bidirectional_lstm  demux BiLSTM(48), whole sequence         [B, T, 96]
  lstm_last           demux LSTM(64), last h                   [B, 64]
"""

import ctypes

import torch

from . import launches, _build
from ..ops import rnn

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'pp_lstm2_stacked': [_P] * 8 + [_I, _I, _I, _P],
    'pp_lstm_seq': [_P] * 8 + [_I, _I, _I, _P],
    'pp_lstm_last': [_P] * 4 + [_I, _I, _I, _P],
    'pp_lstm_launch_shape': [_I, _I, _I, _P],
}
STACKED_HIDDEN = (48,)
SEQ_HIDDEN = (48,)
LAST_HIDDEN = (48, 64)
# kernel numbers of pp_lstm_launch_shape
_KERNELS = {'lstm2_stacked': 0, 'bidirectional_lstm': 1, 'lstm_last': 2}


def _lib():
    return _build.library('lstm.cu', _SIGNATURES)


def launch_shape(name, batch, hidden):
    """(reads per block, threads per block, blocks) of the kernel behind
    wrapper ``name`` for ``batch`` reads of width ``hidden``."""
    shape = (ctypes.c_int * 3)()
    _build.check(_lib().pp_lstm_launch_shape(_KERNELS[name], hidden, batch,
                                             ctypes.addressof(shape)), name)
    return tuple(shape)


def _check_layer(name, params, inputs, hidden_sizes):
    rec = params['recurrent']
    hidden = rec.shape[0]
    if hidden not in hidden_sizes:
        raise ValueError('{}: no kernel for hidden size {}'.format(
            name, hidden))
    if (tuple(rec.shape) != (hidden, 4 * hidden) or
            tuple(params['kernel'].shape) != (inputs, 4 * hidden) or
            tuple(params['bias'].shape) != (4 * hidden,)):
        raise ValueError('{}: weight shapes do not match'.format(name))
    for t in params.values():
        if t.dtype != torch.float32:
            raise ValueError('{}: weights must be float32'.format(name))
    return hidden


def _check_input(name, xs):
    if xs.dim() != 3 or xs.dtype != torch.float32:
        raise ValueError('{}: xs must be float32 [B, T, I]'.format(name))
    if xs.shape[0] == 0 or xs.shape[1] == 0:
        raise ValueError('{}: empty batch or sequence'.format(name))


def lstm2_stacked(params1, params2, xs):
    """Two stacked LSTM layers; layer 2's last h [B, H]. On CUDA the input
    width must be 1: the kernel computes x * kernel + bias itself."""
    if xs.device.type == 'cpu':
        return rnn.lstm2_stacked(params1, params2, xs)
    _check_input('lstm2_stacked', xs)
    if xs.shape[2] != 1:
        raise ValueError('lstm2_stacked: the kernel takes input width 1, '
                         'not {}'.format(xs.shape[2]))
    h1 = _check_layer('lstm2_stacked', params1, 1, STACKED_HIDDEN)
    h2 = _check_layer('lstm2_stacked', params2, h1, STACKED_HIDDEN)
    if h1 != h2:
        raise ValueError('lstm2_stacked: layers of unequal width')
    k1, b1, r1 = params1['kernel'], params1['bias'], params1['recurrent']
    k2, b2, r2 = params2['kernel'], params2['bias'], params2['recurrent']
    batch, seqlen, _ = xs.shape
    out = torch.empty((batch, h2), dtype=torch.float32, device=xs.device)
    _build.require_cuda('lstm2_stacked', xs, k1, b1, r1, k2, b2, r2, out)
    with _build.device_guard(xs):
        code = _lib().pp_lstm2_stacked(
            _build.ptr(xs), _build.ptr(k1), _build.ptr(b1), _build.ptr(r1),
            _build.ptr(k2), _build.ptr(b2), _build.ptr(r2), _build.ptr(out),
            batch, seqlen, h1, _build.stream(xs.device))
    _build.check(code, 'lstm2_stacked')
    launches['lstm2_stacked'] += 1
    return out


def bidirectional_lstm(fwd_params, bwd_params, xs):
    """Keras Bidirectional(concat) LSTM: [B, T, 2H]. On CUDA the input width
    must be 1: the kernel computes x * kernel + bias itself."""
    if xs.device.type == 'cpu':
        return rnn.bidirectional_lstm(fwd_params, bwd_params, xs)
    _check_input('bidirectional_lstm', xs)
    if xs.shape[2] != 1:
        raise ValueError('bidirectional_lstm: the kernel takes input width '
                         '1, not {}'.format(xs.shape[2]))
    hidden = _check_layer('bidirectional_lstm', fwd_params, 1, SEQ_HIDDEN)
    if _check_layer('bidirectional_lstm', bwd_params, 1,
                    SEQ_HIDDEN) != hidden:
        raise ValueError('bidirectional_lstm: directions of unequal width')
    kf, bf, rf = fwd_params['kernel'], fwd_params['bias'], \
        fwd_params['recurrent']
    kb, bb, rb = bwd_params['kernel'], bwd_params['bias'], \
        bwd_params['recurrent']
    batch, seqlen, _ = xs.shape
    out = torch.empty((batch, seqlen, 2 * hidden), dtype=torch.float32,
                      device=xs.device)
    _build.require_cuda('bidirectional_lstm', xs, kf, bf, rf, kb, bb, rb, out)
    p = _build.ptr
    with _build.device_guard(xs):
        code = _lib().pp_lstm_seq(
            p(xs), p(kf), p(bf), p(rf), p(kb), p(bb), p(rb), p(out), batch,
            seqlen, hidden, _build.stream(xs.device))
    _build.check(code, 'bidirectional_lstm')
    launches['bidirectional_lstm'] += 1
    return out


def lstm_last(params, xs):
    """One LSTM layer's last h [B, H] (return_sequences=False)."""
    if xs.device.type == 'cpu':
        return rnn.lstm(params, xs, return_sequences=False)
    _check_input('lstm_last', xs)
    hidden = _check_layer('lstm_last', params, xs.shape[2], LAST_HIDDEN)
    batch, seqlen, inputs = xs.shape
    # rnn.project's product; the kernel adds the bias with the same rounding
    xk = torch.matmul(xs.reshape(batch * seqlen, inputs), params['kernel'])
    out = torch.empty((batch, hidden), dtype=torch.float32, device=xs.device)
    bias, rec = params['bias'], params['recurrent']
    _build.require_cuda('lstm_last', xk, bias, rec, out)
    with _build.device_guard(xk):
        code = _lib().pp_lstm_last(_build.ptr(xk), _build.ptr(bias),
                                   _build.ptr(rec), _build.ptr(out), batch,
                                   seqlen, hidden, _build.stream(xs.device))
    _build.check(code, 'lstm_last')
    launches['lstm_last'] += 1
    return out
