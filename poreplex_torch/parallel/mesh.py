"""The devices of one process's data-parallel mesh.

Reads are independent, so the mesh is one axis over devices and each
device runs the whole pipeline on its share of a batch. It holds this
process's own devices only: with several ranks each rank analyses its own
reads and only the final counts cross processes (distributed.py).
"""

import torch

from ..config import resolve_device


def select_devices(config=None):
    """The mesh of ``config``. On CUDA (``device`` 'cuda'): every visible
    card, capped by ``mesh_shape`` (int N: the first N cards) as
    poreplex-tpu caps its local devices; an explicit 'cuda:N' pins that one
    card. On the CPU: ``mesh_shape`` entries (default 1) of the CPU device,
    so the sharded code runs where there is no card. A caller may also
    hand an analyzer its own list, which may repeat a device."""
    config = config or {}
    device = resolve_device(config.get('device', 'cuda'))
    n = config.get('mesh_shape')
    if device.type == 'cpu':
        return [device] * int(n or 1)
    if device.index is not None:
        if n and int(n) != 1:
            raise ValueError('device {} pins one card; mesh_shape={} wants '
                             'more'.format(device, n))
        return [device]
    devices = [torch.device('cuda', k)
               for k in range(torch.cuda.device_count())]
    if n:
        devices = devices[:int(n)]
    return devices


def pad_to_multiple(n, m):
    return ((n + m - 1) // m) * m
