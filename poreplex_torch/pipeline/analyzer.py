"""Per-batch analysis driver with upstream poreplex's per-read control flow
and status lattice, run as batch phases:

  A  host read load from the session's source (metadata, raw signal
     pooled to pA frames, basecall: pipeline/ingest.py), in this process
     or over ingest worker processes; with on-the-fly basecalling the
     raw signal is kept in place of the file's basecall
  B  device stage 1: scaler + QC + scaling + Viterbi extents + demux net
  C  host: segments, gates, basecall events (or albacore's basecall of
     the kept signal) and adapter trimming; the poly(A) rounds and the
     unsplit-read windows on the device
  D  demux resolution from the stage-1 probabilities
  E  report dicts, and the adapter-signal and basecalled-event dumps

A read can stop at any phase with a status from the taxonomy; later
phases skip stopped reads. A kernel that fails to build or launch stops
the batch: no per-read catch turns it into a missing poly(A) tail or an
unfiltered read. With a mesh of several devices (parallel/mesh.py), stage
1, the poly(A) rounds and the unsplit windows spread each batch's reads
over them; the per-read results are those of one device.
"""

import csv
import os
import sys
import traceback

import numpy as np

from ..config import ingest_process_count
from ..parallel.mesh import select_devices
from ..parallel.sharding import ShardedEngine
from ..utils import GLOBAL_TIMER, pack_unhandled_exception, trace
from .engine import DeviceEngine
# EVENT_COLUMNS and pool_signal are PHASE A's, named here for callers
from .ingest import (EVENT_COLUMNS, IngestPool, ingest_params,  # noqa: F401
                     load_one, load_summed, pool_signal)
from .polya import PolyaAnalyzer
from .read import ReadRecord
from .source import DirectorySource
from .unsplit import UnsplitReadDetector


class SignalAnalysisError(Exception):
    pass


def read_kmer_size(path):
    """k of the k-mer model table: the length of its first k-mer."""
    with open(path, newline='') as f:
        rows = csv.reader(f, delimiter='\t')
        next(rows)                       # header
        return len(next(rows)[0])


class BatchAnalyzer:
    """Models, engine and per-batch phases; reused across batches. Reads
    come from ``source`` (pipeline/source.py), the input directory's FAST5
    files unless another is given. The batches run on ``devices``, the
    config's mesh (parallel/mesh.select_devices) unless a list is given;
    with more than one, ``stage1`` is a ShardedEngine over them."""

    def __init__(self, config, source=None, devices=None):
        self.config = config
        self.inputdir = config['inputdir']
        self.source = source if source is not None else \
            DirectorySource(self.inputdir)
        self.stride = config['signal_processing']['rough_signal_stride']
        self.devices = list(devices or select_devices(config))
        self.engine = DeviceEngine(config, device=self.devices[0])
        self.stage1 = (ShardedEngine(self.engine, self.devices)
                       if len(self.devices) > 1 else self.engine)
        if self.engine.scaler.input_stride != self.stride:
            # the scaler head is rebuilt on the device from the pooled
            # body, so both must share one pooling
            raise ValueError(
                'scaler input stride ({}) must match rough_signal_stride '
                '({})'.format(self.engine.scaler.input_stride, self.stride))
        self.kmersize = read_kmer_size(config['kmer_model'])
        self.polya_analyzer = (
            PolyaAnalyzer(config['polya_dwell'], devices=self.devices)
            if config['measure_polya'] else None)
        self.unsplit_detector = (
            UnsplitReadDetector(config, self.engine.unsplitmodel,
                                devices=self.devices)
            if config['filter_unsplit_reads'] else None)
        if config['barcoding']:
            self.demux_threshold = self.engine.demux.score_threshold(
                config['barcoding_quality_filter'])
        self.albacore = None
        if config['albacore_onthefly']:
            from ..basecall_albacore import AlbacoreBroker
            self.albacore = AlbacoreBroker(config['albacore_configuration'],
                                           self.kmersize)
        # PHASE A's worker processes, started here (inside the session's
        # S:build_analyzer) so that the first batch does not wait for them
        self.ingest_params = ingest_params(config, self.engine.scaler)
        self.ingest_pool = None
        processes = ingest_process_count(config)
        if processes:
            self.ingest_pool = IngestPool(self.source, self.ingest_params,
                                          processes)
            try:
                self.ingest_pool.warm()
            except Exception:
                # the batches are then loaded in this process
                traceback.print_exc()
                self.close()

    def close(self):
        """Stop the ingest workers, if any."""
        if self.ingest_pool is not None:
            self.ingest_pool.shutdown()
            self.ingest_pool = None

    # ------------------------------------------------------------------
    def load_batch(self, reads):
        """PHASE A: reads is a list of (fast5_filename, read_id). Returns
        the preloaded state for process_batch: (results of reads that
        stopped here, records that go on). With ingest workers the batch
        is loaded over them; a pool that raises is shut down and the
        batch, and every later one, is loaded in this process."""
        with trace('A:fast5_load'):
            payloads = None
            if self.ingest_pool is not None:
                try:
                    payloads, parts = self.ingest_pool.load(reads)
                except Exception:
                    traceback.print_exc()
                    self.close()
            if payloads is None:
                payloads, parts = load_summed(reads, self.source,
                                              self.ingest_params)
            for name, seconds in parts.items():
                GLOBAL_TIMER.add_sum(name, seconds)
            results, records = [], []
            for p in payloads:
                self._file_payload(p, results, records)
        return results, records

    def add_read(self, rec, reader, results, records):
        """Load one read from an open reader (a Fast5Reader, or any object
        with its metadata attributes, get_raw_dac and get_basecall) and
        file the record under results (stopped) or records. The caller
        closes the reader."""
        self._file_payload(load_one(self.ingest_params, reader, rec.filename,
                                    rec.read_id, trace),
                           results, records, rec)

    def _file_payload(self, p, results, records, rec=None):
        """File a read's PHASE A payload (pipeline/ingest.py) under
        results, as its report, or under records, as the ReadRecord that
        goes on."""
        if 'error' in p:
            results.append(p['error'])
            return
        if rec is None:
            rec = ReadRecord(p['filename'], self.inputdir, p['read_id'])
        if 'meta' in p:
            (rec.sampling_rate, rec.duration, rec.channel, rec.start_time_s,
             rec.run_id, rec.sample_id) = p['meta']
        rec.set_status(p['status'], stop=p['stopped'])
        if rec.is_stopped():
            results.append(rec.report())
            return
        rec.pooled = p['pooled']
        rec.head_len = p['head_len']
        rec.raw_dac = p.get('raw_dac')
        rec.raw_pa = p.get('raw_pa')
        rec.calib = p.get('calib', rec.calib)
        rec.bcall = p.get('bcall')
        rec.bcall_error = p.get('bcall_error')
        rec.kept_read = p.get('kept_read')
        records.append(rec)

    # ------------------------------------------------------------------
    def process_batch(self, reads, preloaded=None):
        """reads: list of (fast5_filename, read_id), or None with
        ``preloaded`` from load_batch. Returns (the report dicts, the dump
        payloads for the session's DumpWriter)."""
        if preloaded is None:
            preloaded = self.load_batch(reads)
        results, records = preloaded
        aux = {'adapter_dumps': [], 'event_dumps': []}
        if not records:
            return results, aux

        # ---- PHASE B: device stage 1 ----
        with trace('B:device_stage1'):
            stage1 = self.run_stage1(records)

        for i, rec in enumerate(records):
            if not stage1['qc_ok'][i]:
                rec.set_status('scaling_qc_fail', stop=True)
                continue
            rec.set_scaling_params(
                np.asarray(stage1['scaling'][i], np.float32))
            rec.segments = self.engine.segmodel.segments_dict(
                stage1['first'][i], stage1['last'][i], stage1['present'][i])

        # ---- PHASE C ----
        failed = {}     # rec -> SignalAnalysisError status
        demux_slots = {}
        survivors = []
        polya_items = []
        for i, rec in enumerate(records):
            if rec.is_stopped():
                continue
            segments = rec.segments
            if 'adapter' not in segments:
                failed[rec] = 'adapter_not_detected'
                continue
            if self.config['dump_adapter_signals']:
                self._dump_adapter_signal(rec, stage1['scaling'][i], aux)
            if self.config['barcoding'] and stage1['demux_ok'][i]:
                demux_slots[rec] = stage1['demux_probs'][i]
            if self.polya_analyzer is not None:
                rough_range = segments.get(
                    'polya-tail', (segments['adapter'][1] + 1, None))
                polya_items.append((rec, rough_range))
            survivors.append(rec)

        if polya_items:
            with trace('C:polya'):
                self.polya_analyzer.process_batch(polya_items, self.stride)

        unsplit_jobs = []       # (rec, payload_start, windows)
        dump_jobs = []          # (rec, events)
        with trace('C:events_trim'):
            for rec in survivors:
                try:
                    events = self._load_events(rec)
                    if self.config['dump_basecalls']:
                        dump_jobs.append((rec, events))
                    if self.config['trim_adapter']:
                        self._trim_adapter(rec, events)
                    if self.unsplit_detector is not None:
                        payload_start, windows = \
                            self.unsplit_detector.collect_windows(
                                rec, rec.segments, self.stride)
                        if windows:
                            unsplit_jobs.append((rec, payload_start,
                                                 windows))
                except SignalAnalysisError as exc:
                    failed[rec] = exc.args[0]
                except Exception as exc:
                    err = pack_unhandled_exception(
                        rec.filename, rec.read_id, exc, sys.exc_info()[2])
                    rec.set_error(err['status'], err['error_message'])

        if unsplit_jobs:
            self._filter_unsplit(unsplit_jobs, failed)
        for rec, events in dump_jobs:
            self._dump_events(rec, events, aux)

        # sequence length filter + labels
        for rec in survivors:
            if rec in failed or rec.error_message:
                continue
            if rec.sequence is not None:
                readlength = len(rec.sequence[0]) - rec.sequence[2]
                if readlength < self.config['minimum_sequence_length']:
                    failed[rec] = 'sequence_too_short'

        for rec, status in failed.items():
            rec.set_status(status, stop=True)
            rec.set_label('artifact' if status == 'unsplit_read' else 'fail')
        for rec in survivors:
            if rec not in failed and not rec.error_message:
                rec.set_label('pass')

        # ---- PHASE D: demux resolution ----
        if self.config['barcoding']:
            demux = self.engine.demux
            for rec, probs in demux_slots.items():
                bcid = int(np.argmax(probs)) - demux.number_of_decoy_labels
                score = float(np.max(probs))
                effective = (bcid if bcid >= 0 and
                             score >= self.demux_threshold else None)
                rec.set_barcode(effective, bcid,
                                demux.lookup_calibrated_phred_score(score))

        # ---- PHASE E: reports ----
        for rec in records:
            results.append(rec.report())
            rec.clear_cache()
        return results, aux

    def run_stage1(self, records):
        """Stage 1 of every record: all sub-batches are enqueued on the
        devices before the first result is read back."""
        frames = self.engine.seg_frames
        reads = [(rec.pooled, min(len(rec.pooled), frames), rec.head_len)
                 for rec in records]
        handles = []
        counts = []
        while reads:
            with trace('B:pack'):
                wire, n = self.stage1.pack_stage1_flat(reads)
            with trace('B:dispatch'):
                handles.append(self.stage1.dispatch_stage1_flat(wire))
            counts.append(n)
            reads = reads[n:]
        with trace('B:collect'):
            chunks = [self.stage1.collect_stage1_flat(h) for h in handles]
        return {k: np.concatenate([c[k][:cnt] for c, cnt in
                                   zip(chunks, counts)])
                for k in chunks[0]}

    def _filter_unsplit(self, jobs, failed):
        """Decode every unsplit window of the batch on the device, then
        mark the reads that hold more than one molecule."""
        flat = [(rec, lo, hi) for rec, _, windows in jobs
                for lo, hi in windows]
        with trace('C:unsplit_viterbi'):
            runs = self.unsplit_detector.decode_runs_batched(flat)
        cursor = 0
        with trace('C:unsplit_analyze'):
            for rec, payload_start, windows in jobs:
                wruns = runs[cursor:cursor + len(windows)]
                cursor += len(windows)
                try:
                    if self.unsplit_detector.analyze_read(
                            rec, payload_start, windows, wruns):
                        failed[rec] = 'unsplit_read'
                except Exception as exc:
                    err = pack_unhandled_exception(
                        rec.filename, rec.read_id, exc, sys.exc_info()[2])
                    rec.set_error(err['status'], err['error_message'])

    # ------------------------------------------------------------------
    def _load_events(self, rec):
        if self.albacore is not None:
            events = self._call_albacore(rec)
        else:
            events = self._load_fast5_events(rec)

        scale, shift = rec.scaling_params
        events['scaled_mean'] = events['mean'] * float(scale) + float(shift)
        events['pos'] = np.cumsum(events['move'])
        duration = np.hstack(
            (np.diff(events['start']), [1])).astype(np.int64)
        events['end'] = events['start'] + duration
        rec.events = events
        return events

    def _load_fast5_events(self, rec):
        if rec.bcall_error is not None:
            raise rec.bcall_error
        bcall = rec.bcall
        if bcall is None:
            raise SignalAnalysisError('not_basecalled')
        rec.sequence_length = bcall['sequence_length']
        rec.mean_qscore = bcall['mean_qscore']
        rec.num_events = bcall['num_events']
        rec.sequence = (bcall['sequence'], bcall['qstring'], 0)
        return bcall['events']

    def _call_albacore(self, rec):
        """albacore's basecall of the kept signal, timed as
        ``C:albacore``. The read is named by its file's name without the
        extension, as in poreplex-tpu (not by its read id)."""
        kept = rec.kept_read
        with trace('C:albacore'):
            bcall = self.albacore.basecall(
                kept.get_raw_data(), kept,
                os.path.basename(rec.filename).rsplit('.', 1)[0])
        if bcall is None:
            raise SignalAnalysisError('not_basecalled')
        rec.sequence_length = bcall['sequence_length']
        rec.mean_qscore = bcall['mean_qscore']
        rec.num_events = bcall['called_events']
        rec.sequence = (bcall['sequence'], bcall['qstring'], 0)
        return bcall['events']

    def _scaled_pooled_signal(self, rec, scaling):
        scale, shift = scaling
        return rec.pooled * float(scale) + float(shift)

    def _dump_adapter_signal(self, rec, scaling, aux):
        """The adapter's scaled pooled frames and its raw sample span."""
        a0, a1 = rec.segments['adapter']
        signal = self._scaled_pooled_signal(rec, scaling)[a0:a1 + 1]
        if len(signal) > 0:
            aux['adapter_dumps'].append(
                (rec.read_id, np.asarray(signal, np.float32),
                 a0 * self.stride, (a1 + 1) * self.stride))

    def _dump_events(self, rec, events, aux):
        """The basecalled events with the read's scaling, adapter and
        poly(A) positions as attributes."""
        attrs = []
        if rec.scaling_params is not None:
            attrs.append(('signal_scale', rec.scaling_params[0]))
            attrs.append(('signal_shift', rec.scaling_params[1]))
        if 'adapter' in rec.segments:
            attrs.append(('adapter_begin',
                          np.uint32(rec.segments['adapter'][0] * self.stride)))
            attrs.append(('adapter_end',
                          np.uint32((rec.segments['adapter'][1] + 1) *
                                    self.stride)))
        if rec.polya is not None:
            if 'polya-tail' in rec.segments:
                attrs.append(('polya_end_debug',
                              np.uint32((rec.segments['polya-tail'][1] + 1) *
                                        self.stride)))
            attrs.append(('polya_begin', np.uint32(rec.polya['begin'])))
            attrs.append(('polya_end', np.uint32(rec.polya['end'])))
            attrs.append(('spikes', repr(rec.polya['spikes']).encode()))
        aux['event_dumps'].append((rec.read_id, events.copy(), attrs))

    def _trim_adapter(self, rec, events):
        """Upstream poreplex returns early whenever a sequence exists,
        which makes signal-guided trimming a no-op; ``fix_trim_adapter:
        true`` in the preset enables the evidently intended trimming."""
        sequence = rec.sequence
        if sequence is None or not self.config.get('fix_trim_adapter'):
            return

        adapter_end = rec.segments['adapter'][1] * self.stride
        kmer_lead_size = self.kmersize // 2
        sel = events['start'] <= adapter_end
        if sel.sum() <= 0:
            return
        adapter_basecall_length = int(events['move'][sel].sum()) + \
            kmer_lead_size
        if adapter_basecall_length > len(sequence[0]):
            raise SignalAnalysisError('basecall_table_incomplete')
        elif adapter_basecall_length > 0:
            rec.set_adapter_trimming_length(adapter_basecall_length)
