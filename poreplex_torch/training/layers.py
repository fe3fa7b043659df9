"""Initialisation and optimizer shared by the two trainers.

The distributions are the JAX trainers' (``init_params`` of poreplex-tpu's
``train_demux.py`` and ``train_scaler.py``); the numbers come from a
``torch.Generator``, so they agree with JAX's in distribution, not in
value.
"""

import math

import torch
from torch import nn


def lstm_params(generator, in_dim, hidden):
    """Keras-layout LSTM parameters on the generator's device: a uniform
    ``kernel`` [I, 4H] within sqrt(6 / (I + 4H)), an orthogonal
    ``recurrent`` [H, 4H] (orthonormal rows) and a ``bias`` [4H] of zeros
    with the forget gate's at 1."""
    device = generator.device
    lim = math.sqrt(6.0 / (in_dim + 4 * hidden))
    kernel = torch.empty(in_dim, 4 * hidden, device=device).uniform_(
        -lim, lim, generator=generator)
    recurrent = nn.init.orthogonal_(
        torch.empty(hidden, 4 * hidden, device=device), generator=generator)
    bias = torch.zeros(4 * hidden, device=device)
    bias[hidden:2 * hidden] = 1.0
    return {'kernel': kernel, 'recurrent': recurrent, 'bias': bias}


def dense_params(generator, in_dim, out_dim):
    """A uniform ``kernel`` [I, O] within sqrt(6 / (I + O)), a zero
    ``bias``."""
    device = generator.device
    lim = math.sqrt(6.0 / (in_dim + out_dim))
    kernel = torch.empty(in_dim, out_dim, device=device).uniform_(
        -lim, lim, generator=generator)
    return {'kernel': kernel, 'bias': torch.zeros(out_dim, device=device)}


def make_optimizer(net, learning_rate=1e-3):
    """Adam with optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root."""
    return torch.optim.Adam(net.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)
