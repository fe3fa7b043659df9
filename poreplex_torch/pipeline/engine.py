"""Stage 1 on the device: scaler LSTMs + output transform + QC, per-read
scaling, segmentation Viterbi with segment extents, then the demux window
gather with med/MAD and the demux network.

The batch crosses to the device as two arrays (the token-packed wire of
poreplex-tpu's engine): one flat stream of every read's pooled frames,
concatenated end to end and quantized per read (u16, or u8 with
``wire_precision='fast'``), and an aux table [B, 6] f32 of (offset,
pooled_len, head_len, valid, lo, step). The padded [B, T] layout and the
scaler head are rebuilt on the device; the result comes back as one packed
[B, C] f32 array whose columns ``_unpack_stage1`` reads. The padded wire
(``pack_stage1``: [B, wire_frames + 3] u16 rows and a [B, 2] (lo, step)
table) is the one poreplex-tpu's sharded engine splits by rows; the
analyzer sends the token-packed one.
"""

import copy

import numpy as np
import torch

from ..config import resolve_device
from ..models.demux import DemuxModel, PAD_FILLER
from ..models.scaler import ScalerModel
from ..models.segmentation import SegmentationHMM
from ..ops import normalize, rnn

STATE_ADAPTER = 'adapter'


class DeviceEngine:

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device or config['device'])
        rnn.use_full_fp32()
        sp = config['signal_processing']
        self.stride = sp['rough_signal_stride']
        self.scan_limit = config['segmentation']['segmentation_scan_limit']
        self.seg_frames = self.scan_limit // self.stride      # 6666

        self.scaler = ScalerModel(
            sp['scaler_model'], sp['scaler_qc_threshold'],
            input_length=sp.get('scaler_input_length'), device=self.device)
        self.segmodel = SegmentationHMM(config['segmentation_model'],
                                        device=self.device)
        self.unsplitmodel = SegmentationHMM(
            config['unsplit_read_detection_model'], device=self.device)

        self.barcoding = bool(config.get('barcoding'))
        if self.barcoding:
            dmx = config['demultiplexing']
            self.demux = DemuxModel(dmx['demux_model'],
                                    dmx['number_of_decoy_labels'],
                                    device=self.device)
            self.demux_minlen = dmx['minimum_dna_length']
            self.demux_maxlen = dmx['maximum_dna_length']
            self.demux_trimlen = dmx['signal_trim_length']
        else:
            self.demux = None
        self.adapter_idx = self.segmodel.state_index[STATE_ADAPTER]

        # the pooled body covers the scaler head too (the head is the first
        # <= pooled_length frames, left-zero-padded), so one signal array
        # crosses to the device and the head is rebuilt there
        self.wire_frames = max(self.seg_frames, self.scaler.pooled_length)

        # per-read affine quantization v = lo + q * step over the read's
        # own [min, max]: 'exact' u16 (<= 0.01 pA over a 1.4 nA range),
        # 'fast' u8 (254 steps, half the bytes)
        self.wire_fast = config.get('wire_precision', 'exact') == 'fast'

        B = int(config.get('device_batch_size', 256))
        self.batch_rows = B
        self.flat_size = B * max(self.wire_frames + 1, 1664)
        # offsets ride the f32 aux table: past 2**24 they would round and
        # reads would dequantize from wrong positions
        if self.flat_size >= 1 << 24:
            raise ValueError(
                'device_batch_size * wire frames = {} exceeds the f32 '
                'integer-exact offset range (2**24); lower '
                'device_batch_size or segmentation_scan_limit'.format(
                    self.flat_size))

    def replica(self, device):
        """This engine on ``device``: the same configuration and shapes,
        the models' weights copied from this engine's device."""
        device = resolve_device(device)
        if device == self.device:
            return self
        twin = copy.copy(self)
        twin.device = device
        for name in ('scaler', 'segmodel', 'unsplitmodel', 'demux'):
            model = getattr(self, name)
            if model is not None:
                setattr(twin, name, copy.deepcopy(model).to(device))
        return twin

    # ------------------------------------------------------------------
    def _derive_heads(self, pooled, head_len):
        """The scaler input: the first ``head_len`` frames right-aligned
        into a zero-left-padded [B, pooled_length] window."""
        hl = self.scaler.pooled_length
        j = torch.arange(hl, device=pooled.device)[None, :]
        idx = j - (hl - head_len[:, None])
        heads = torch.gather(pooled, 1, idx.clamp(0, pooled.shape[1] - 1))
        return torch.where(idx >= 0, heads, 0.0)

    def _stage1(self, pooled, pooled_len, head_len, head_valid):
        """pooled [B, wire_frames] raw pooled pA; pooled_len [B] valid
        segmentation frames; head_len [B]; head_valid [B] bool."""
        scaling, qc_ok = self.scaler(self._derive_heads(pooled, head_len))
        qc_ok = qc_ok & head_valid
        scaled = (pooled[:, :self.seg_frames] * scaling[:, 0:1] +
                  scaling[:, 1:2])
        first, last, present, logp = self.segmodel.extents(scaled,
                                                           pooled_len)
        out = {'scaling': scaling, 'qc_ok': qc_ok, 'first': first,
               'last': last, 'present': present, 'logp': logp}

        if self.barcoding:
            a0 = first[:, self.adapter_idx]
            a1 = last[:, self.adapter_idx]
            alen = a1 - a0 + 1
            demux_ok = (present[:, self.adapter_idx] &
                        (alen >= self.demux_minlen) &
                        (alen <= self.demux_maxlen))
            # the last min(alen, trimlen) adapter frames, right-aligned
            tl = self.demux_trimlen
            k = torch.arange(tl, device=scaled.device)
            idx = a1[:, None] - (tl - 1) + k[None, :]
            valid = idx >= a0[:, None]
            win = torch.gather(scaled, 1, idx.clamp(0, scaled.shape[1] - 1))
            win_norm = torch.where(
                valid, normalize.med_mad_normalize(win, valid), PAD_FILLER)
            out.update({'demux_ok': demux_ok,
                        'demux_probs': self.demux(win_norm),
                        'adapter_len': alen})
        return out

    def _pack_outputs(self, out):
        cols = [out['scaling'],                                  # 2
                out['qc_ok'][:, None].to(torch.float32),         # 1
                out['first'].to(torch.float32),                  # S
                out['last'].to(torch.float32),                   # S
                out['present'].to(torch.float32),                # S
                out['logp'][:, None]]                            # 1
        if self.barcoding:
            cols += [out['demux_ok'][:, None].to(torch.float32),
                     out['demux_probs'],
                     out['adapter_len'][:, None].to(torch.float32)]
        return torch.cat(cols, dim=1)

    def _unpack_stage1(self, arr):
        S = self.segmodel.nstates
        out = {}
        c = 0
        out['scaling'] = arr[:, 0:2]; c = 2
        out['qc_ok'] = arr[:, c] > 0.5; c += 1
        out['first'] = arr[:, c:c + S].astype(np.int64); c += S
        out['last'] = arr[:, c:c + S].astype(np.int64); c += S
        out['present'] = arr[:, c:c + S] > 0.5; c += S
        out['logp'] = arr[:, c]; c += 1
        if self.barcoding:
            out['demux_ok'] = arr[:, c] > 0.5; c += 1
            out['demux_probs'] = arr[:, c:c + 5]; c += 5
            out['adapter_len'] = arr[:, c].astype(np.int64); c += 1
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _quantize_stream(chunks, flat, qparams, qmax):
        """Per-read affine quantization of ``chunks`` (1-D f32 arrays) laid
        end to end into ``flat`` from offset 0, with chunk i's (lo, step)
        written to ``qparams[i]``. Returns the samples written."""
        if not chunks:
            return 0
        lens = np.fromiter((len(c) for c in chunks), np.int64, len(chunks))
        total = int(lens.sum())
        if total == 0:
            qparams[:len(chunks)] = (0.0, 1e-7)
            return 0
        stream = np.concatenate(chunks) if len(chunks) > 1 else \
            np.asarray(chunks[0], np.float32)
        offsets = np.zeros(len(chunks), np.int64)
        np.cumsum(lens[:-1], out=offsets[1:])
        nz = lens > 0
        lo = np.zeros(len(chunks), np.float64)
        hi = np.zeros(len(chunks), np.float64)
        lo[nz] = np.minimum.reduceat(stream, offsets[nz])
        hi[nz] = np.maximum.reduceat(stream, offsets[nz])
        step = np.maximum((hi - lo) / qmax, 1e-7)
        qparams[:len(chunks), 0] = lo
        qparams[:len(chunks), 1] = step
        rep_lo = np.repeat(lo, lens).astype(np.float32)
        rep_step = np.repeat(step, lens).astype(np.float32)
        q = np.clip(np.round((stream - rep_lo) / rep_step), 0, qmax)
        flat[:total] = q.astype(flat.dtype)
        return total

    def pack_stage1(self, pooled, pooled_len, head_len=None,
                    head_valid=None):
        """The padded wire of one batch: (packed [B, wire_frames + 3] u16,
        rows of quantized pooled frames then head_len, head_valid,
        pooled_len; qparams [B, 2] f32 per-read (lo, step)).

        pooled: [B, <= wire_frames] f32 pooled pA; pooled_len: [B] valid
        segmentation frames; head_len: [B] scaler-head frames (default
        min(pooled_length, pooled_len)); head_valid: [B] bool."""
        pooled = np.asarray(pooled, np.float32)
        n, w = pooled.shape
        pooled_len = np.asarray(pooled_len, np.uint16)
        if head_len is None:
            head_len = np.minimum(self.scaler.pooled_length,
                                  pooled_len).astype(np.uint16)
        if head_valid is None:
            head_valid = np.ones(n, bool)
        stored = np.minimum(np.maximum(pooled_len, head_len), w)
        packed = np.zeros((n, self.wire_frames + 3), np.uint16)
        qparams = np.zeros((n, 2), np.float32)
        qparams[:, 1] = 1.0
        chunks = [pooled[i, :stored[i]] for i in range(n)]
        flat = np.zeros(int(stored.sum()), np.uint16)
        self._quantize_stream(chunks, flat, qparams, 65535)
        off = 0
        for i in range(n):
            packed[i, :stored[i]] = flat[off:off + stored[i]]
            off += int(stored[i])
        packed[:, self.wire_frames] = np.asarray(head_len, np.uint16)
        packed[:, self.wire_frames + 1] = np.asarray(head_valid, np.uint16)
        packed[:, self.wire_frames + 2] = pooled_len
        return packed, qparams

    def _stage1_packed(self, packed, qparams):
        """packed: the padded wire's rows (u16 as int16 bits) [B, w + 3];
        qparams [B, 2] f32."""
        w = self.wire_frames
        packed = packed.to(torch.int32) & 0xFFFF
        head_len = packed[:, w]
        head_valid = packed[:, w + 1] > 0
        pooled_len = packed[:, w + 2]
        pooled = qparams[:, 0:1] + packed[:, :w].to(torch.float32) * \
            qparams[:, 1:2]
        stored = torch.maximum(pooled_len, head_len)[:, None]
        j = torch.arange(w, device=packed.device)[None, :]
        pooled = torch.where(j < stored, pooled, 0.0)
        out = self._stage1(pooled, pooled_len, head_len, head_valid)
        return self._pack_outputs(out)

    @torch.inference_mode()
    def dispatch_stage1(self, packed):
        """Copies a pack_stage1 batch to the device and enqueues stage 1;
        returns the device result for collect_stage1."""
        arr, qparams = packed
        arr_d = torch.from_numpy(arr.view(np.int16)).to(self.device)
        qp_d = torch.from_numpy(qparams).to(self.device)
        return self._stage1_packed(arr_d, qp_d)

    def collect_stage1(self, handle):
        return self._unpack_stage1(handle.cpu().numpy())

    def run_stage1(self, pooled, pooled_len, head_len=None, head_valid=None):
        """numpy in, numpy out through the padded wire."""
        packed = self.pack_stage1(pooled, pooled_len, head_len, head_valid)
        return self.collect_stage1(self.dispatch_stage1(packed))

    # ------------------------------------------------------------------
    def pack_stage1_flat(self, reads):
        """reads: list of (pooled_f32_1d, pooled_len, head_len). Packs up to
        batch_rows reads, as many as fit the flat buffer; returns (wire,
        n_packed); reads past n_packed go in the next call."""
        B = self.batch_rows
        cap = self.flat_size
        aux = np.zeros((B, 6), np.float32)
        aux[:, 5] = 1.0
        used = 0
        n = 0
        chunks = []
        for pooled, plen, hlen in reads[:B]:
            stored = min(len(pooled), self.wire_frames)
            if used + stored > cap:
                break
            aux[n, :4] = (used, min(plen, stored), min(hlen, stored), 1)
            chunks.append(pooled[:stored])
            used += stored
            n += 1

        dtype, qmax = ((np.uint8, 254) if self.wire_fast
                       else (np.uint16, 65535))
        flat = np.zeros(cap, dtype)
        self._quantize_stream(chunks, flat, aux[:, 4:], qmax)
        return (flat, aux), n

    def _gather_flat(self, stream, meta):
        """stream [FLAT] f32; meta [B, 4] (offset, pooled_len, head_len,
        valid) -> padded [B, wire_frames] and the frame index row."""
        offset = meta[:, 0].to(torch.int64)
        j = torch.arange(self.wire_frames, device=stream.device)[None, :]
        stored = torch.maximum(meta[:, 1], meta[:, 2])[:, None]
        idx = (offset[:, None] + j).clamp(0, stream.shape[0] - 1)
        return torch.where(j < stored, stream[idx], 0.0), j

    def _stage1_flat(self, flat, aux):
        """flat: the quantized stream (u16 as int16 bits, or u8); aux [B, 6]
        f32. Dequantizes per read after the gather, runs stage 1 and packs
        the outputs."""
        if flat.dtype == torch.int16:
            stream = (flat.to(torch.int32) & 0xFFFF).to(torch.float32)
        else:
            stream = flat.to(torch.float32)
        meta = aux[:, :4].to(torch.int32)
        q, j = self._gather_flat(stream, meta)
        stored = torch.maximum(meta[:, 1], meta[:, 2])[:, None]
        pooled = aux[:, 4:5] + q * aux[:, 5:6]
        pooled = torch.where(j < stored, pooled, 0.0)
        out = self._stage1(pooled, meta[:, 1], meta[:, 2], meta[:, 3] > 0)
        return self._pack_outputs(out)

    @torch.inference_mode()
    def dispatch_stage1_flat(self, wire):
        """Copies one packed batch to the device and enqueues stage 1;
        returns the device result for collect_stage1_flat."""
        flat, aux = wire
        if flat.dtype == np.uint16:
            flat = flat.view(np.int16)
        flat_d = torch.from_numpy(flat).to(self.device)
        aux_d = torch.from_numpy(aux).to(self.device)
        return self._stage1_flat(flat_d, aux_d)

    def collect_stage1_flat(self, handle):
        return self._unpack_stage1(handle.cpu().numpy())

    def run_stage1_flat(self, reads):
        """Packs and runs as many of ``reads`` as fit; returns (outputs
        dict, n_packed)."""
        wire, n = self.pack_stage1_flat(reads)
        out = self.collect_stage1_flat(self.dispatch_stage1_flat(wire))
        return {k: v[:n] for k, v in out.items()}, n
