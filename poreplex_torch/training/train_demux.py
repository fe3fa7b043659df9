#!/usr/bin/env python3
"""Demultiplexer training: BiLSTM(48) -> LSTM(64) -> Dense(5, softmax)
(``init_params`` takes other widths) with the cost-matrix-weighted
crossentropy, phred calibration table computation, and an npz checkpoint
that ``models.demux.DemuxModel`` (and poreplex-tpu's) loads.

The PyTorch counterpart of poreplex-tpu's ``training/train_demux.py``: the
network runs the plain differentiable recurrences of ``ops/rnn.py`` under
autograd, on the CUDA device unless the caller asks for the CPU, with
``torch.optim.Adam`` (optax.adam's formula). For the same seed it draws the
same dataset and the same batches as the JAX trainer; initialisation and
noise come from ``torch.Generator``s seeded as the JAX trainer seeds its
keys, so they agree in distribution, not in value. ``--data-parallel``
trains on one rank a visible card, where JAX shards the batch over a mesh
of every local device (``parallel/training.py``).

    python -m poreplex_torch.training.train_demux -o demux.npz \
        [--data-parallel] [--cpu]
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import weights
from ..config import resolve_device
from ..ops import rnn
from ..parallel import training as ranks
from ..parallel.mesh import select_devices
from . import layers, losses
from .calibration import compute_calibration_table
from .data import demux_dataset

NUM_CLASSES = 5
DEFAULT_COST_MAT = np.array(
    [[1.0] * 5] + [[1.0, 2.0, 2.0, 2.0, 2.0]] * 4, np.float32)
NOISE_STDDEV = 0.05
LABEL_IDS = {'decoy': 0, 'BC1': 1, 'BC2': 2, 'BC3': 3, 'BC4': 4}


def init_params(generator, hidden1=48, hidden2=64):
    """Nested {layer: {key: tensor}} on the generator's device."""
    return {
        'bilstm_fwd': layers.lstm_params(generator, 1, hidden1),
        'bilstm_bwd': layers.lstm_params(generator, 1, hidden1),
        'lstm2': layers.lstm_params(generator, 2 * hidden1, hidden2),
        'dense': layers.dense_params(generator, hidden2, NUM_CLASSES),
    }


class DemuxNet(nn.Module):
    """The demux network with trainable parameters in Keras layout, one
    ParameterDict per checkpoint layer."""

    def __init__(self, state):
        super().__init__()
        weights.parameter_dicts(self, state, weights.DEMUX_LAYERS)

    @classmethod
    def from_params(cls, params, device=None):
        """Trainable copies of ``params``: nested (``init_params`` of either
        package) or flat (a checkpoint), numpy or tensors."""
        return cls(weights.demux_state_dict(params, device,
                                            requires_grad=True))

    def forward(self, windows, noise=None):
        """windows [B, T] -> probabilities [B, 5]; ``noise`` [B, T] is the
        train-time Gaussian noise, added first like the reference model's
        GaussianNoise layer."""
        x = windows if noise is None else windows + noise
        h = rnn.bidirectional_lstm(self.bilstm_fwd, self.bilstm_bwd,
                                   x[..., None])
        h = rnn.lstm(self.lstm2, h, return_sequences=False)
        return torch.softmax(rnn.dense(self.dense, h), dim=-1)


def loss(net, windows, labels, cost_mat, noise=None, all_reduce=None):
    """The weighted crossentropy of the batch; with ``all_reduce`` (a
    rank's sum over the ranks), this rank's share of the global batch's
    (losses.shard_weighted_categorical_crossentropy)."""
    probs = net(windows, noise)
    onehot = F.one_hot(labels.long(), NUM_CLASSES).to(probs.dtype)
    if all_reduce is None:
        return losses.weighted_categorical_crossentropy(onehot, probs,
                                                        cost_mat)
    return losses.shard_weighted_categorical_crossentropy(
        onehot, probs, cost_mat, all_reduce)


def train_step(net, optimizer, windows, labels, noise, cost_mat,
               replica=None):
    """One Adam step on the weighted crossentropy; returns the loss before
    the update. With ``replica`` (parallel/training.py) this process is
    one rank of a data-parallel world, given the whole global batch: it
    computes on its rows, and its loss and gradients are the global
    batch's, summed over the ranks."""
    optimizer.zero_grad(set_to_none=True)
    if replica is None:
        value = loss(net, windows, labels, cost_mat, noise)
        value.backward()
    else:
        rows = replica.rows(len(windows))
        value = loss(net, windows[rows], labels[rows], cost_mat, noise[rows],
                     replica.all_reduce)
        value.backward()
        value = replica.sum_gradients(net, value)
    optimizer.step()
    return value.detach()


def save_checkpoint(path, net, calibration, cost_mat):
    flat = weights.checkpoint_arrays(net, weights.DEMUX_LAYERS)
    flat['calibration'] = np.asarray(calibration, np.float64)
    flat['loss_weights'] = np.asarray(cost_mat, np.float32)
    np.savez(path, **flat)


def train(output_path, steps=300, batch_size=64, n_per_class=400, seed=0,
          learning_rate=1e-3, eval_fraction=0.25, log=print, data=None,
          device='cuda', devices=None):
    """data: optional (windows, labels), e.g. from data.dumps_dataset over
    adapter-signal dump inventories of barcoded control runs; defaults to
    the synthetic set. devices: None to train in this process on
    ``device``; else a list as parallel.mesh.select_devices gives, one rank
    a device (a world of one for one device), the batch rounded to a
    multiple of the ranks as the JAX trainer rounds it for its mesh.
    Returns the held-out accuracy."""
    options = dict(output_path=output_path, steps=steps,
                   batch_size=batch_size, n_per_class=n_per_class, seed=seed,
                   learning_rate=learning_rate, eval_fraction=eval_fraction,
                   data=data)
    if devices is None:
        return fit(None, resolve_device(device), log, **options)
    return ranks.launch(fit, devices, options, log)


def fit(replica, device, log, output_path, steps, batch_size, n_per_class,
        seed, learning_rate, eval_fraction, data):
    """train() in this process on ``device``: alone (``replica`` None) or
    as one rank of a data-parallel world, which draws the global batches
    and noise as one process does and, on rank 0 alone, evaluates and
    writes the checkpoint (the other ranks return None)."""
    if device.type == 'cuda':
        rnn.use_full_fp32()
    rng = np.random.RandomState(seed)
    windows, labels = data if data is not None else \
        demux_dataset(n_per_class, rng)
    n_eval = int(len(windows) * eval_fraction)
    train_w, train_l = windows[n_eval:], labels[n_eval:]
    eval_w, eval_l = windows[:n_eval], labels[:n_eval]

    cost_mat = torch.as_tensor(DEFAULT_COST_MAT, device=device)
    net = DemuxNet.from_params(init_params(
        torch.Generator(device=device).manual_seed(seed)))
    if replica is not None:
        replica.broadcast(net)
        batch_size = ranks.round_batch(batch_size, replica.world)
    optimizer = layers.make_optimizer(net, learning_rate)
    noise_gen = torch.Generator(device=device).manual_seed(seed + 1)

    for step in range(steps):
        idx = rng.randint(0, len(train_w), batch_size)
        batch = torch.as_tensor(np.asarray(train_w[idx], np.float32),
                                device=device)
        noise = NOISE_STDDEV * torch.randn(batch.shape, generator=noise_gen,
                                           device=device)
        value = train_step(net, optimizer, batch,
                           torch.as_tensor(train_l[idx], device=device),
                           noise, cost_mat, replica)
        if step % 50 == 0 or step == steps - 1:
            log('step {:4d} loss {:.4f}'.format(step, float(value)))
    if replica is not None and replica.rank != 0:
        return None

    with torch.no_grad():
        probs = net(torch.as_tensor(np.asarray(eval_w, np.float32),
                                    device=device)).cpu().numpy()
    pred = probs.argmax(axis=1)
    scores = probs.max(axis=1)
    acc = float((pred == eval_l).mean())
    # calibration uses barcode-vs-barcode errors only (decoys excluded,
    # reference: compute_score_calibration_table.py:63-66)
    mask = (eval_l > 0) & (pred > 0)
    calibration = compute_calibration_table(scores[mask],
                                            (pred == eval_l)[mask])
    save_checkpoint(output_path, net, calibration, DEFAULT_COST_MAT)
    log('eval accuracy {:.4f}; checkpoint -> {}'.format(acc, output_path))
    return acc


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-o', '--output', required=True)
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--dumps', action='append', default=[],
                        metavar='LABEL=INVENTORY_H5',
                        help='adapter-signal dump inventory of a barcoded '
                             'control run (--dump-adapter-signals output); '
                             'LABEL one of decoy/BC1..BC4; repeatable — '
                             'when given, trains on the dumps instead of '
                             'synthetic data')
    parser.add_argument('--data-parallel', default=False,
                        action='store_true',
                        help='shard training batches over all local devices: '
                             'one rank a visible card (one CPU rank with '
                             '--cpu)')
    parser.add_argument('--cpu', default=False, action='store_true',
                        help='train on the CPU instead of the CUDA device')
    args = parser.parse_args(argv)
    device = 'cpu' if args.cpu else 'cuda'
    devices = select_devices({'device': device}) if args.data_parallel \
        else None

    data = None
    if args.dumps:
        from .data import dumps_dataset
        runs = []
        for spec in args.dumps:
            label, path = spec.split('=', 1)
            runs.append((path, LABEL_IDS[label]))
        data = dumps_dataset(runs, rng=np.random.RandomState(args.seed))

    train(args.output, steps=args.steps, batch_size=args.batch_size,
          seed=args.seed, data=data, device=device, devices=devices)


if __name__ == '__main__':
    sys.exit(main())
