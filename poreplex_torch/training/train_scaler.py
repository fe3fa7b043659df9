#!/usr/bin/env python3
"""Scaler training: LSTM(48) -> LSTM(48) -> Dense(2) (``init_params``
takes another width) regression of per-read (scale, shift), with
standardized targets and the output-transform metadata stored in the
checkpoint, which ``models.scaler.ScalerModel`` (and poreplex-tpu's)
loads.

The PyTorch counterpart of poreplex-tpu's ``training/train_scaler.py``:
the stacked recurrence of ``ops/rnn.py`` under autograd, on the CUDA device
unless the caller asks for the CPU, ``torch.optim.Adam`` (optax.adam's
formula), Pearson-r/RMSD evaluation like the reference prints. For the same
seed it draws the same dataset and batches as the JAX trainer.
``--data-parallel`` trains on one rank a visible card, where JAX shards the
batch over a mesh of every local device (``parallel/training.py``).

    python -m poreplex_torch.training.train_scaler -o scaler.npz \
        [--data-parallel] [--cpu]
"""

import argparse
import json
import sys

import numpy as np
import torch
from torch import nn

from .. import weights
from ..config import resolve_device
from ..ops import rnn
from ..parallel import training as ranks
from ..parallel.mesh import select_devices
from . import layers
from .data import scaler_dataset

# the shipped scaler's input definition, stored in every checkpoint
INPUT_DEFS = {'dtype': 'float32', 'stride': 15, 'length': 30000,
              'min_length': 9000}


def init_params(generator, hidden=48):
    """Nested {layer: {key: tensor}} on the generator's device."""
    return {
        'lstm1': layers.lstm_params(generator, 1, hidden),
        'lstm2': layers.lstm_params(generator, hidden, hidden),
        'dense': layers.dense_params(generator, hidden, 2),
    }


class ScalerNet(nn.Module):
    """The scaler network with trainable parameters in Keras layout, one
    ParameterDict per checkpoint layer."""

    def __init__(self, state):
        super().__init__()
        weights.parameter_dicts(self, state, weights.SCALER_LAYERS)

    @classmethod
    def from_params(cls, params, device=None):
        """Trainable copies of ``params``: nested (``init_params`` of either
        package) or flat (a checkpoint), numpy or tensors."""
        return cls(weights.scaler_state_dict(params, device,
                                             requires_grad=True))

    def forward(self, heads):
        """heads [B, T] -> standardized (scale, shift) [B, 2]."""
        h = rnn.lstm2_stacked(self.lstm1, self.lstm2, heads[..., None])
        return rnn.dense(self.dense, h)


def loss(net, heads, targets_std):
    return torch.mean((net(heads) - targets_std) ** 2)


def shard_loss(net, heads, targets_std, world):
    """One rank's share of the mean squared error of a global batch split
    in ``world`` equal shares: its rows' squared errors over the global
    batch's count."""
    return torch.sum((net(heads) - targets_std) ** 2) / \
        (targets_std.numel() * world)


def train_step(net, optimizer, heads, targets_std, replica=None):
    """One Adam step on the mean squared error; returns the loss before the
    update. With ``replica`` (parallel/training.py) this process is one
    rank of a data-parallel world, given the whole global batch: it
    computes on its rows, and its loss and gradients are the global
    batch's, summed over the ranks."""
    optimizer.zero_grad(set_to_none=True)
    if replica is None:
        value = loss(net, heads, targets_std)
        value.backward()
    else:
        rows = replica.rows(len(heads))
        value = shard_loss(net, heads[rows], targets_std[rows], replica.world)
        value.backward()
        value = replica.sum_gradients(net, value)
    optimizer.step()
    return value.detach()


def save_checkpoint(path, net, transform, input_defs):
    flat = weights.checkpoint_arrays(net, weights.SCALER_LAYERS)
    flat['meta'] = np.frombuffer(json.dumps({
        'input': input_defs,
        'output_transform': transform,
        'model_version': 'poreplex-tpu-scaler (retrained)',
    }).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def train(output_path, steps=400, batch_size=32, n_samples=2000, seed=0,
          learning_rate=1e-3, eval_fraction=0.2, log=print, data=None,
          device='cuda', devices=None):
    """data: optional (heads [N, T], targets [N, 2]) in place of the
    synthetic set. devices: None to train in this process on ``device``;
    else a list as parallel.mesh.select_devices gives, one rank a device (a
    world of one for one device), the batch rounded to a multiple of the
    ranks as the JAX trainer rounds it for its mesh. Returns
    {'scale'|'shift': {'pearson_r', 'rmsd'}} on the held-out heads."""
    options = dict(output_path=output_path, steps=steps,
                   batch_size=batch_size, n_samples=n_samples, seed=seed,
                   learning_rate=learning_rate, eval_fraction=eval_fraction,
                   data=data)
    if devices is None:
        return fit(None, resolve_device(device), log, **options)
    return ranks.launch(fit, devices, options, log)


def fit(replica, device, log, output_path, steps, batch_size, n_samples,
        seed, learning_rate, eval_fraction, data):
    """train() in this process on ``device``: alone (``replica`` None) or
    as one rank of a data-parallel world, which draws the global batches
    as one process does and, on rank 0 alone, evaluates and writes the
    checkpoint (the other ranks return None)."""
    if device.type == 'cuda':
        rnn.use_full_fp32()
    rng = np.random.RandomState(seed)
    heads, targets = (data if data is not None
                      else scaler_dataset(n_samples, rng))
    heads = np.asarray(heads, np.float32)
    targets = np.asarray(targets, np.float32)
    n_samples = len(heads)
    n_eval = int(n_samples * eval_fraction)
    tr_h, tr_t = heads[n_eval:], targets[n_eval:]
    ev_h, ev_t = heads[:n_eval], targets[:n_eval]

    # standardize targets; the stats become the stored output transform
    # (poreplex/signal_loader.py:58-60 applies std * pred + mean)
    mean = tr_t.mean(axis=0)
    std = tr_t.std(axis=0)
    transform = {'scale_mean': float(mean[0]), 'scale_std': float(std[0]),
                 'shift_mean': float(mean[1]), 'shift_std': float(std[1])}
    tr_std = (tr_t - mean) / std

    net = ScalerNet.from_params(init_params(
        torch.Generator(device=device).manual_seed(seed)))
    if replica is not None:
        replica.broadcast(net)
        batch_size = ranks.round_batch(batch_size, replica.world)
    optimizer = layers.make_optimizer(net, learning_rate)

    for step in range(steps):
        idx = rng.randint(0, len(tr_h), batch_size)
        value = train_step(net, optimizer,
                           torch.as_tensor(tr_h[idx], device=device),
                           torch.as_tensor(tr_std[idx], device=device),
                           replica)
        if step % 50 == 0 or step == steps - 1:
            log('step {:4d} loss {:.4f}'.format(step, float(value)))
    if replica is not None and replica.rank != 0:
        return None

    with torch.no_grad():
        pred = net(torch.as_tensor(ev_h, device=device)).cpu().numpy() * \
            std + mean
    stats = {}
    for i, name in enumerate(('scale', 'shift')):
        r = np.corrcoef(pred[:, i], ev_t[:, i])[0, 1]
        rmsd = float(np.sqrt(np.mean((pred[:, i] - ev_t[:, i]) ** 2)))
        stats[name] = {'pearson_r': float(r), 'rmsd': rmsd}
        log('{}: pearson r {:.4f}  rmsd {:.4f}'.format(name, r, rmsd))

    save_checkpoint(output_path, net, transform, INPUT_DEFS)
    log('checkpoint -> {}'.format(output_path))
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-o', '--output', required=True)
    parser.add_argument('--steps', type=int, default=400)
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--seed', type=int, default=0)
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
    train(args.output, steps=args.steps, batch_size=args.batch_size,
          seed=args.seed, device=device, devices=devices)


if __name__ == '__main__':
    sys.exit(main())
