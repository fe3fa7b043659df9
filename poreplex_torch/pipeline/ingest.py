"""PHASE A ingest: a batch's reads loaded from the session's source into
picklable payloads, in the analyzer's process or fanned out over
spawn-context worker processes (``-p/--parallel``).

h5py holds the interpreter lock through every call (libhdf5 is not
thread-safe), so ingest threads would not read FAST5 in parallel, and
would take the lock from the threads that drive the device. Worker
processes read in parallel: each gets the session's source once, when it
starts, opens every read through ``source.opener()`` and returns compact
payloads (the pooled pA frames, the raw DAC when poly(A) is measured, the
basecall, or with on-the-fly basecalling the raw DAC and what albacore
takes with it). Everything that touches the device stays in the analyzer's
process. A worker reads a ``DirectorySource``'s FAST5 through the native
reader (``fast5_native.py``) first and through h5py for each read that
reader leaves (guppy Move tables, other layouts, any native error); a
``MemorySource`` is sent to each worker once.

Workers import numpy, scipy and, inside the FAST5 functions, h5py; never
torch. The in-process path runs the same ``load_summed``, so both share one
status lattice: ``disappeared``, ``irregular_fast5``,
``scaler_signal_too_short``, a deferred basecall error, and the packed
report of an unhandled exception.
"""

import atexit
import contextlib
import os
import pickle
import sys
import time
import traceback

import numpy as np

from .. import fast5, fast5_native
from ..utils import pack_unhandled_exception
from .source import DirectorySource

# basecall event columns stage C reads (an albacore Events read fetches
# only these members); the event dumps take every column
EVENT_COLUMNS = ('mean', 'start', 'move', 'p_model_state')

# the stages of a read's load, each summed over a batch inside A:fast5_load
STAGES = ('A:open', 'A:raw', 'A:pool', 'A:bcall')


def pool_signal(raw, stride, pa_scale, offset):
    """Stride-mean pooling of a raw DAC signal into pA frames. The mean is
    taken in DAC units and the affine pA = pa_scale * (dac + offset) is
    applied to the pooled means only: the mean commutes with the affine,
    so this is the pooled pA signal at 1/stride of the conversion work."""
    trimmed = raw[:len(raw) - len(raw) % stride]
    pooled = trimmed.reshape(-1, stride).mean(axis=1, dtype=np.float32)
    return pooled * np.float32(pa_scale) + np.float32(pa_scale * offset)


def ingest_params(config, scaler):
    """What PHASE A needs of the run's config and of the scaler head, as a
    picklable dict."""
    return dict(
        stride=config['signal_processing']['rough_signal_stride'],
        input_length=scaler.input_length,
        min_length=scaler.min_length,
        pooled_length=scaler.pooled_length,
        # poly(A) windows are cut from the raw signal
        keep_raw=bool(config['measure_polya']),
        # albacore basecalls each read in PHASE C: the file's basecall is
        # not read
        albacore=bool(config['albacore_onthefly']),
        event_columns=None if config['dump_basecalls'] else EVENT_COLUMNS)


class NativeFallback(Exception):
    """The native reader leaves this read to the next opener (h5py)."""


def read_payload(params, reader, timer):
    """One read's PHASE A from an open reader (a fast5.Fast5Reader, a
    simulate.MemoryRead, or any object with their metadata attributes,
    get_raw_dac and get_basecall): a dict of 'status', 'stopped' and
    'meta' and, for a read that goes on, its pooled pA frames, the scaler
    head's length in them, the raw signal when poly(A) is measured, and
    its basecall or the exception reading it raised ('bcall_error',
    raised in PHASE C so that stage-1 statuses keep their precedence);
    with on-the-fly basecalling, a fast5.KeptRead ('kept_read') in place
    of the basecall.
    ``timer(stage)`` is a context manager that times a stage."""
    p = {'status': 'okay', 'stopped': False,
         'meta': (reader.sampling_rate, reader.duration,
                  reader.channel_number,
                  round(reader.start_time / reader.sampling_rate, 3),
                  reader.run_id, reader.sample_id)}

    # minimum-signal gate of the scaler head
    sigload_length = min(params['input_length'], reader.duration)
    sigload_length -= sigload_length % params['stride']
    if sigload_length < params['min_length']:
        p.update(status='scaler_signal_too_short', stopped=True)
        return p

    with timer('A:raw'):
        raw = reader.get_raw_dac()
    with timer('A:pool'):
        p['pooled'] = pool_signal(raw, params['stride'], reader.pa_scale,
                                  reader.offset)
    if params['keep_raw']:
        # a 16-bit DAC stays integer (a lossless wire), a wider one
        # becomes pA
        if raw.dtype.kind in 'iu' and raw.dtype.itemsize <= 2:
            p['raw_dac'] = raw
            p['calib'] = (float(reader.pa_scale), float(reader.offset))
        else:
            p['raw_pa'] = np.asarray(
                raw * np.float32(reader.pa_scale) +
                np.float32(reader.pa_scale * reader.offset), np.float32)
    p['head_len'] = min(params['pooled_length'], len(p['pooled']))
    if params['albacore']:
        p['kept_read'] = fast5.KeptRead(reader, raw)
        return p

    try:
        with timer('A:bcall'):
            p['bcall'] = reader.get_basecall(
                columns=params['event_columns'])
    except NativeFallback:
        raise
    except Exception as exc:
        p['bcall_error'] = exc
    return p


def load_one(params, reader, filename, read_id, timer):
    """read_payload, with an unhandled exception packed as the read's
    report ('error'); NativeFallback passes through."""
    try:
        p = read_payload(params, reader, timer)
    except NativeFallback:
        raise
    except Exception as exc:
        return {'error': pack_unhandled_exception(
            filename, read_id, exc, sys.exc_info()[2])}
    p.update(filename=filename, read_id=read_id)
    return p


def _open_and_load(open_read, filename, read_id, params, timer, readers):
    try:
        with timer('A:open'):
            reader = open_read(filename, read_id)
    except NativeFallback:
        raise
    except Exception:
        traceback.print_exc()
        return {'filename': filename, 'read_id': read_id,
                'status': 'irregular_fast5', 'stopped': True}
    readers.append(reader)
    return load_one(params, reader, filename, read_id, timer)


def load_reads(reads, source, params, timer, openers=None):
    """PHASE A of ``reads``, (filename, read_id) entries of ``source``:
    one payload a read, in order. Each read is opened by the first of
    ``openers`` (by default the source's own) that does not raise
    NativeFallback; the last one never does. Readers stay open until the
    batch is loaded, so the reads of one multi-read file share one
    handle."""
    openers = openers or [source.opener()]
    payloads = []
    readers = []
    try:
        for filename, read_id in reads:
            if not source.exists(filename):
                payloads.append({'filename': filename, 'read_id': read_id,
                                 'status': 'disappeared', 'stopped': True})
                continue
            for open_read in openers:
                try:
                    payloads.append(_open_and_load(
                        open_read, filename, read_id, params, timer,
                        readers))
                    break
                except NativeFallback:
                    continue
    finally:
        for reader in readers:
            reader.close()
    return payloads


def load_summed(reads, source, params, openers=None):
    """load_reads with each of STAGES timed as one sum over the reads:
    (payloads, {stage: wall seconds}), each stage added once a batch
    rather than once a read."""
    totals = dict.fromkeys(STAGES, 0.0)

    @contextlib.contextmanager
    def timer(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            totals[name] += time.perf_counter() - t0
    return load_reads(reads, source, params, timer, openers), totals


# ---------------------------------------------------------------- native

class NativeRead:
    """One read of an open fast5_native.NativeFast5 behind the reader
    surface read_payload reads. Whatever the native reader cannot read
    raises NativeFallback."""

    def __init__(self, nf, read_id):
        try:
            nodes = nf.nodes_for(read_id)
            meta = None if nodes is None else nf.read_meta(*nodes[:3])
        except Exception:
            raise NativeFallback(read_id)
        if meta is None or (not nf.is_multiread and
                            meta['read_id'] != read_id):
            raise NativeFallback(read_id)
        self.nf = nf
        self.signal_node, self.analyses_node = nodes[3:]
        self.read_id = read_id
        self.duration = meta['duration']
        self.start_time = meta['start_time']
        self.channel_number = meta['channel_number']
        self.sampling_rate = meta['sampling_rate']
        self.run_id = meta['run_id']
        self.sample_id = meta['sample_id']
        self.offset = meta['offset']
        self.pa_scale = meta['range'] / meta['digitisation']

    def get_raw_dac(self):
        try:
            raw = self.nf.read_signal(self.signal_node, self.duration)
        except Exception:
            raw = None
        if raw is None:
            raise NativeFallback(self.read_id)
        return raw

    def get_basecall(self, columns=None):
        """The basecall with the columns of EVENT_COLUMNS (and the k-mer
        of each event); ``columns`` is always those."""
        try:
            bcall = self.nf.read_basecall(self.analyses_node)
        except Exception:
            bcall = 'fallback'
        if bcall == 'fallback':
            raise NativeFallback(self.read_id)
        return bcall

    def close(self):
        pass        # the file stays open for the chunk


class NativeOpener:
    """open(filename, read_id) -> NativeRead for a DirectorySource's
    files; each file is opened once, and closed by close()."""

    def __init__(self, topdir):
        self.topdir = topdir
        self.files = {}

    def __call__(self, filename, read_id):
        path = os.path.join(self.topdir, filename)
        if path not in self.files:
            self.files[path] = fast5_native.NativeFast5.open(path)
        if self.files[path] is None:
            raise NativeFallback(read_id)
        return NativeRead(self.files[path], read_id)

    def close(self):
        for nf in self.files.values():
            if nf is not None:
                nf.close()
        self.files.clear()


# ---------------------------------------------------------------- workers

_SOURCE = None
_PARAMS = None
_BARRIER = None

# seconds a ping waits for the other workers' pings
WARM_TIMEOUT = 300


def _init_worker(source, params, barrier):
    global _SOURCE, _PARAMS, _BARRIER
    _SOURCE, _PARAMS, _BARRIER = source, params, barrier


def _worker_ping():
    """(pid, the top-level packages this worker has imported), once every
    worker holds a ping."""
    _BARRIER.wait(WARM_TIMEOUT)
    return os.getpid(), sorted({name.split('.')[0] for name in sys.modules})


def _picklable(exc):
    try:
        pickle.dumps(exc)
        return exc
    except Exception:
        return RuntimeError('{}: {}'.format(type(exc).__name__, exc))


def load_batch_worker(reads):
    """In a worker: (payloads, {stage: wall seconds}) of a chunk of
    (filename, read_id) entries of the worker's source."""
    native = None
    # the event dumps take every column, which only h5py reads
    if (isinstance(_SOURCE, DirectorySource) and
            _PARAMS['event_columns'] is not None and
            fast5_native.get_library() is not None):
        native = NativeOpener(_SOURCE.topdir)
    try:
        openers = None if native is None else [native, _SOURCE.opener()]
        payloads, totals = load_summed(reads, _SOURCE, _PARAMS, openers)
    finally:
        if native is not None:
            native.close()
    for p in payloads:
        if 'bcall_error' in p:
            p['bcall_error'] = _picklable(p['bcall_error'])
    return payloads, totals


class IngestPool:
    """Spawn-context process pool for PHASE A. ``load`` blocks its caller
    (a session's monitor thread) with the interpreter lock released while
    the workers read."""

    # reads a chunk when one batch is fanned out over the workers
    CHUNK_READS = 64

    def __init__(self, source, params, processes):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        context = multiprocessing.get_context('spawn')
        self.processes = processes
        self._pool = ProcessPoolExecutor(
            processes, mp_context=context, initializer=_init_worker,
            initargs=(source, params, context.Barrier(processes)))
        atexit.register(self.shutdown)

    def warm(self):
        """Start every worker: the executor spawns a worker for a task
        only while none is idle, so each ping waits for the others;
        returns what each ping returned."""
        futures = [self._pool.submit(_worker_ping)
                   for _ in range(self.processes)]
        return [f.result() for f in futures]

    def worker_pids(self):
        """The process ids of the workers started."""
        return sorted(self._pool._processes)

    def load(self, reads):
        """One batch's PHASE A over the workers: (payloads in the order of
        ``reads``, {stage: wall seconds}). The batch is cut into one
        chunk a worker, of at least CHUNK_READS reads; a stage's time is
        the largest of its chunks' sums, the chunk the batch waited on,
        so that it stays within the batch's wall time."""
        step = max(self.CHUNK_READS, -(-len(reads) // self.processes))
        futures = [self._pool.submit(load_batch_worker, reads[lo:lo + step])
                   for lo in range(0, len(reads), step)]
        payloads = []
        timers = dict.fromkeys(STAGES, 0.0)
        for f in futures:
            chunk, totals = f.result()
            payloads.extend(chunk)
            for name, secs in totals.items():
                timers[name] = max(timers[name], secs)
        return payloads, timers

    def shutdown(self):
        pool, self._pool = self._pool, None
        if pool is not None:
            atexit.unregister(self.shutdown)
            pool.shutdown(wait=True, cancel_futures=True)
