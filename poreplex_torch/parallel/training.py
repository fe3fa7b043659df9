"""Data-parallel training over ranks, the port's counterpart of the JAX
trainers' mesh (poreplex-tpu's ``parallel/mesh.py``: ``make_mesh``,
``batch_sharding`` and ``replicated_sharding``).

The JAX trainers shard each batch over a mesh of every local device in one
process, and XLA inserts the gradient all-reduce. A training step here is
host dispatch of some 70,000 (demux) to 320,000 (scaler) small kernels, so
one host thread driving D cards would take about D times as long a step.
The port runs one process (a rank) a device instead, joined by
torch.distributed: NCCL on the cards, gloo on the CPU, where a list may
repeat the CPU device so that tests run several ranks on one host.

Every rank computes what one process computes on the whole batch:

- the batch is rounded to a multiple of the world as JAX rounds it; every
  rank draws the same global indices from the same ``RandomState`` and
  computes on its contiguous rows of the global batch;
- the parameters are rank 0's, broadcast before the first step;
- each rank's loss is its rows' share of the global loss (for the demux,
  its weighted sum over the all-reduced weight sum of the whole batch), and
  one flat all-reduce a step sums every gradient and the loss across ranks
  (SUM, no averaging);
- every rank runs the same Adam on the same sums; rank 0 alone evaluates
  and writes the checkpoint.
"""

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import resolve_device

# how long a rank waits for the others to join or to reach a collective:
# a rank that hangs makes the others fail instead of waiting for ever
TIMEOUT = timedelta(minutes=10)


def round_batch(batch_size, world):
    """The global batch at ``world`` ranks: a multiple of the world, at
    least a row a rank (poreplex-tpu's ``training/train_demux.py:128-130``).
    """
    return max(world, batch_size - batch_size % world)


def backend(devices):
    """The process-group backend of one rank on each of ``devices``: NCCL
    for cards, each card once; gloo for the CPU device, which may repeat.
    Raises ValueError where neither applies: cards never fall back to
    gloo."""
    devices = [resolve_device(d) for d in devices]
    types = {d.type for d in devices}
    if not devices:
        raise ValueError('data-parallel training needs at least one device')
    if types == {'cpu'}:
        return 'gloo'
    if types != {'cuda'}:
        raise ValueError('data-parallel training runs on cards or on the '
                         'CPU, not on both: {}'.format(devices))
    if not dist.is_nccl_available():
        raise ValueError('NCCL is not available in this PyTorch build; '
                         'data-parallel training on cards needs it')
    indices = [d.index for d in devices]
    if None in indices or len(set(indices)) != len(indices):
        raise ValueError('every card must be named once by its index, as '
                         'NCCL takes one rank a card: {}'.format(devices))
    return 'nccl'


class Replica:
    """One rank of a data-parallel world whose process group this process
    has joined (``join``): its rows of each global batch and the
    collectives of its step."""

    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def rows(self, batch_size):
        """This rank's contiguous rows of a global batch of
        ``batch_size``."""
        if batch_size % self.world:
            raise ValueError('a global batch of {} does not split into {} '
                             'equal shares'.format(batch_size, self.world))
        share = batch_size // self.world
        return slice(self.rank * share, (self.rank + 1) * share)

    def all_reduce(self, tensor):
        """``tensor`` summed over the ranks, in place; returned."""
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
        return tensor

    def broadcast(self, module):
        """Rank 0's parameters on every rank, by one flat broadcast: each
        rank builds them from the seed, but QR (``nn.init.orthogonal_``)
        need not round alike on every device."""
        with torch.no_grad():
            params = list(module.parameters())
            flat = torch.cat([p.reshape(-1) for p in params])
            dist.broadcast(flat, 0)
            _unflatten(flat, params)

    def sum_gradients(self, module, loss):
        """Every parameter's gradient and the rank's loss summed over the
        ranks by one flat all-reduce; returns the summed loss, the global
        batch's."""
        params = list(module.parameters())
        flat = torch.cat([p.grad.reshape(-1) for p in params] +
                         [loss.detach().reshape(1)])
        self.all_reduce(flat)
        _unflatten(flat, [p.grad for p in params])
        return flat[-1]


def _unflatten(flat, tensors):
    """Copies consecutive pieces of ``flat`` into ``tensors``."""
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def join(rank, world, address, device):
    """Joins the world of ``world`` ranks as ``rank``, rank 0's store
    listening at ``address`` (HOST:PORT), and returns its Replica. A card
    is made current first: NCCL binds the rank to the current card."""
    device = resolve_device(device)
    if backend([device]) == 'nccl':
        torch.cuda.set_device(device)
        dist.init_process_group('nccl', init_method='tcp://' + address,
                                world_size=world, rank=rank, timeout=TIMEOUT,
                                device_id=device)
    else:
        dist.init_process_group('gloo', init_method='tcp://' + address,
                                world_size=world, rank=rank, timeout=TIMEOUT)
    return Replica(rank, world)


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch(fn, devices, kwargs, log=print):
    """``fn(replica, device, log, **kwargs)`` on one rank a device, each
    rank a process started with the ``spawn`` method; the ranks meet on
    127.0.0.1. Returns rank 0's result; rank 0's ``log`` lines reach
    ``log`` here, the other ranks' are dropped. A rank that raises stops
    every rank, and its traceback is raised here."""
    backend(devices)
    devices = [torch.device(d) for d in devices]
    address = '127.0.0.1:{}'.format(free_port())
    queue = mp.get_context('spawn').SimpleQueue()
    ranks = mp.start_processes(
        _rank_main, args=(fn, devices, address, queue, kwargs),
        nprocs=len(devices), join=False, start_method='spawn')
    result, done = None, False
    while not done:
        done = ranks.join(timeout=0.1)
        while not queue.empty():
            kind, value = queue.get()
            if kind == 'log':
                log(value)
            else:
                result = value
    return result


def _rank_main(rank, fn, devices, address, queue, kwargs):
    """A spawned rank: joins the world, runs fn, and hands rank 0's log
    lines and result to the launching process."""
    # every rank of the world is on this host
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    if devices[rank].type == 'cpu':
        # the CPU ranks share this host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    replica = join(rank, len(devices), address, devices[rank])

    def log(line):
        if rank == 0:
            queue.put(('log', line))

    result = fn(replica, devices[rank], log, **kwargs)
    dist.destroy_process_group()
    if rank == 0:
        queue.put(('result', result))
