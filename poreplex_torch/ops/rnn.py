"""Plain PyTorch LSTMs for the scaler and demultiplexer networks.

These are the reference versions of the CUDA recurrences in
``kernels/lstm.py``: the CPU path runs them, and ``chip_smoke.py`` holds
the kernels against them on the card. Conventions follow poreplex-tpu's
``ops/rnn.py`` so converted Keras weights are used verbatim:

* weights are ``kernel`` [I, 4H], ``recurrent`` [H, 4H], ``bias`` [4H] with
  the Keras gate order [i, f, c, o] (the same order as ``torch.nn.LSTM``'s
  [i, f, g, o]);
* the input projection of every timestep is one GEMM hoisted out of the
  recurrence; the recurrence adds ``h @ recurrent`` per step;
* tanh is the expm1 form, accurate to about one ulp, so long recurrences
  stay aligned with the TensorFlow-computed goldens;
* everything is float32: TF32 is switched off for matrix products and for
  cuDNN (``use_full_fp32``), matching the JAX package's
  ``Precision.HIGHEST``.
"""

import torch


def use_full_fp32():
    """Keep float32 matrix products in full float32 on the card: no TF32
    in cuBLAS (``torch.backends.cuda.matmul.allow_tf32``) or cuDNN
    (``torch.backends.cudnn.allow_tf32``, on by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def accurate_tanh(x):
    x = torch.clamp(x, -20.0, 20.0)
    t = torch.expm1(2.0 * x)
    return t / (t + 2.0)


def lstm_gates(z, c_prev):
    """Keras-ordered LSTM gate math on pre-activations z = [..., 4H]."""
    h4 = z.shape[-1] // 4
    i = torch.sigmoid(z[..., 0 * h4:1 * h4])
    f = torch.sigmoid(z[..., 1 * h4:2 * h4])
    g = accurate_tanh(z[..., 2 * h4:3 * h4])
    o = torch.sigmoid(z[..., 3 * h4:4 * h4])
    c = f * c_prev + i * g
    h = o * accurate_tanh(c)
    return h, c


def project(params, xs):
    """Hoisted input projection: xs [B, T, I] -> zx [B, T, 4H]."""
    batch, seqlen, _ = xs.shape
    zx = torch.matmul(xs.reshape(batch * seqlen, -1), params['kernel']) + \
        params['bias']
    return zx.reshape(batch, seqlen, -1)


def recurrence(zx, recurrent, return_sequences=True):
    """One LSTM layer over pre-activations zx [B, T, 4H]; returns the hidden
    sequence [B, T, H] or the last hidden state [B, H]."""
    batch, seqlen, _ = zx.shape
    hidden = recurrent.shape[0]
    h = zx.new_zeros((batch, hidden))
    c = zx.new_zeros((batch, hidden))
    hs = zx.new_empty((batch, seqlen, hidden)) if return_sequences else None
    for t in range(seqlen):
        h, c = lstm_gates(zx[:, t] + torch.matmul(h, recurrent), c)
        if return_sequences:
            hs[:, t] = h
    return hs if return_sequences else h


def lstm(params, xs, reverse=False, return_sequences=True):
    """One LSTM layer over xs [B, T, I]: [B, T, H] or the last h [B, H]."""
    if reverse:
        xs = torch.flip(xs, (1,))
    out = recurrence(project(params, xs), params['recurrent'],
                     return_sequences)
    if reverse and return_sequences:
        out = torch.flip(out, (1,))
    return out


def lstm2_stacked(params1, params2, xs):
    """Two stacked LSTM layers stepped together (layer 2 consumes layer 1's
    h of the same step); returns layer 2's last h [B, H2]."""
    zx = project(params1, xs)
    r1, r2 = params1['recurrent'], params2['recurrent']
    k2, b2 = params2['kernel'], params2['bias']
    batch, seqlen, _ = zx.shape
    h1 = zx.new_zeros((batch, r1.shape[0]))
    c1 = torch.zeros_like(h1)
    h2 = zx.new_zeros((batch, r2.shape[0]))
    c2 = torch.zeros_like(h2)
    for t in range(seqlen):
        h1, c1 = lstm_gates(zx[:, t] + torch.matmul(h1, r1), c1)
        z2 = torch.matmul(h1, k2) + b2 + torch.matmul(h2, r2)
        h2, c2 = lstm_gates(z2, c2)
    return h2


def bidirectional_lstm(fwd_params, bwd_params, xs):
    """Keras Bidirectional(merge_mode='concat'): [B, T, 2H], the forward
    sequence then the time-realigned backward sequence."""
    fwd = lstm(fwd_params, xs)
    bwd = lstm(bwd_params, xs, reverse=True)
    return torch.cat([fwd, bwd], dim=-1)


def dense(params, xs):
    return torch.matmul(xs, params['kernel']) + params['bias']
