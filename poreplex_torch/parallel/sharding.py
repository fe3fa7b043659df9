"""Stage 1, and the batch launches after it, over the devices of a mesh.

The counterpart of poreplex-tpu's ``parallel/sharding.py``. Where that
package hands XLA one program sharded over a 'batch' axis, here each device
holds a replica of the DeviceEngine (the weights loaded once and copied to
each card) and the host splits the batch: every device's share is copied
to its card and enqueued before anything is read back, so the cards work
at the same time. Reads never cross devices; the wire format and the
per-read results are those of one device.
"""

import numpy as np
import torch

from .mesh import pad_to_multiple


def block_rows(n, n_devices):
    """[(lo, hi)] of each device: ``n`` rows cut into contiguous blocks of
    ceil(n / D), P('batch')'s split of the rows padded to a multiple of D.
    Trailing devices may get fewer rows, or none."""
    size = -(-n // n_devices) if n else 0
    return [(min(d * size, n), min((d + 1) * size, n))
            for d in range(n_devices)]


def shard_batch_arrays(devices, *arrays):
    """[B, ...] numpy arrays cut into the devices' contiguous row blocks,
    each block copied to its device: [(device, lo, hi, tensors)] of the
    devices that get rows. No zero rows are added: a kernel sees only real
    rows."""
    n = arrays[0].shape[0]
    return [(device, lo, hi, [torch.from_numpy(np.ascontiguousarray(
        a[lo:hi])).to(device) for a in arrays])
        for device, (lo, hi) in zip(devices, block_rows(n, len(devices)))
        if hi > lo]


class ShardedEngine:
    """A DeviceEngine's stage 1 over a list of devices (one may repeat)."""

    def __init__(self, engine, devices):
        self.engine = engine
        self.devices = list(devices)
        self.n_devices = len(self.devices)
        self.replicas = {}
        for device in self.devices:
            if device not in self.replicas:
                self.replicas[device] = engine.replica(device)

        # the token-packed wire, sharded: every device gets its own flat
        # stream, and read k of a dispatch lives at device k % D, row
        # k // D
        D = self.n_devices
        self.rows_per_dev = -(-engine.batch_rows // D)
        self.flat_size_dev = max(engine.wire_frames + 1,
                                 -(-engine.flat_size // D))

    # ------------------------------------------------------------------
    # the padded wire: rows cut into contiguous blocks

    @torch.inference_mode()
    def dispatch_stage1(self, packed):
        """Pads a pack_stage1 batch to a multiple of the mesh size (the pad
        rows dequantize with step 1), copies each device's block to it and
        enqueues stage 1 there; returns (handles, n) for collect_stage1."""
        arr, qparams = packed
        n = arr.shape[0]
        pad = pad_to_multiple(n, self.n_devices) - n
        if pad:
            arr = np.pad(arr, [(0, pad), (0, 0)])
            qparams = np.pad(qparams, [(0, pad), (0, 0)])
            qparams[n:, 1] = 1.0
        handles = [self.replicas[device]._stage1_packed(a_d, q_d)
                   for device, _, _, (a_d, q_d) in shard_batch_arrays(
                       self.devices, arr.view(np.int16), qparams)]
        return handles, n

    def collect_stage1(self, handle):
        handles, n = handle
        rows = np.concatenate([h.cpu().numpy() for h in handles])
        return self.engine._unpack_stage1(rows[:n])

    def run_stage1(self, pooled, pooled_len, head_len=None, head_valid=None):
        """numpy in, numpy out; the batch's rows split over the devices."""
        packed = self.engine.pack_stage1(pooled, pooled_len, head_len,
                                         head_valid)
        return self.collect_stage1(self.dispatch_stage1(packed))

    # ------------------------------------------------------------------
    # the token-packed wire, reads round-robined: the drop-in for
    # DeviceEngine's pack / dispatch / collect, so BatchAnalyzer drives a
    # mesh as it drives one device

    def pack_stage1_flat(self, reads):
        """reads: list of (pooled_f32_1d, pooled_len, head_len). Read k goes
        to device k % D, row k // D, and each device's frames make its own
        flat stream. Returns (wire, n_packed); packing stops at the first
        read that no longer fits its home device, so the read <-> (device,
        row) addressing stays implicit."""
        eng = self.engine
        D, R = self.n_devices, self.rows_per_dev
        cap = self.flat_size_dev
        aux = np.zeros((D, R, 6), np.float32)
        aux[:, :, 5] = 1.0
        used = np.zeros(D, np.int64)
        chunks = [[] for _ in range(D)]
        n = 0
        for pooled, plen, hlen in reads[:D * R]:
            d = n % D
            stored = min(len(pooled), eng.wire_frames)
            if used[d] + stored > cap:
                break
            aux[d, n // D, :4] = (used[d], min(plen, stored),
                                  min(hlen, stored), 1)
            chunks[d].append(pooled[:stored])
            used[d] += stored
            n += 1

        dtype, qmax = ((np.uint8, 254) if eng.wire_fast
                       else (np.uint16, 65535))
        flat = np.zeros((D, cap), dtype)
        for d in range(D):
            eng._quantize_stream(chunks[d], flat[d], aux[d, :, 4:], qmax)
        return (flat, aux), n

    @torch.inference_mode()
    def dispatch_stage1_flat(self, wire):
        """Copies each device's flat stream and aux table to it and
        enqueues stage 1 on every device; nothing is read back here."""
        flat, aux = wire
        if flat.dtype == np.uint16:
            flat = flat.view(np.int16)
        handles = []
        for d, device in enumerate(self.devices):
            flat_d = torch.from_numpy(flat[d]).to(device)
            aux_d = torch.from_numpy(aux[d]).to(device)
            handles.append(self.replicas[device]._stage1_flat(flat_d, aux_d))
        return handles

    def collect_stage1_flat(self, handles):
        """Reads the devices' results back and restores read order: row
        (d, r) is read r * D + d."""
        arr = np.stack([h.cpu().numpy() for h in handles])     # [D, R, C]
        rows = arr.transpose(1, 0, 2).reshape(-1, arr.shape[2])
        return self.engine._unpack_stage1(rows)

    def run_stage1_flat(self, reads):
        """Packs and runs as many of ``reads`` as fit; returns (outputs
        dict, n_packed)."""
        wire, n = self.pack_stage1_flat(reads)
        out = self.collect_stage1_flat(self.dispatch_stage1_flat(wire))
        return {k: v[:n] for k, v in out.items()}, n

    def warmup(self):
        """One empty token-packed dispatch on every device, so PyTorch's
        own kernels are loaded on each card before a timed batch."""
        D, R = self.n_devices, self.rows_per_dev
        dtype = np.uint8 if self.engine.wire_fast else np.uint16
        aux = np.zeros((D, R, 6), np.float32)
        aux[:, :, 5] = 1.0
        wire = (np.zeros((D, self.flat_size_dev), dtype), aux)
        self.collect_stage1_flat(self.dispatch_stage1_flat(wire))
