"""The window's read source: the surface of ``poreplex_torch``'s
``pipeline.source.MemorySource``, serving a read pool batch by batch.

Each listed file holds one batch of reads. The pool is served in a new
seeded order on each pass, under fresh read ids, so no batch repeats. The
session lists every file at once (``scan_inputs``), so ``read_ids`` paces
the listing: file k is listed once the session has opened the reads of
the first k - LEAD batches, and once the window's seconds have passed the
listing ends and the session finishes the batches in flight. The wait
holds one of the session's monitor threads; the other runs PHASE A.
"""

import threading
import time

import numpy as np

from . import simulate
from .traffic import seed_sequence

# batches listed ahead of the last batch whose reads were all opened
LEAD = 2
EVENT_COLUMNS = ('mean', 'start', 'move', 'p_model_state')


class PoolReader:
    """One pool read behind the reader surface the session loads from
    (that of ``fast5.Fast5Reader`` and ``simulate.MemoryRead``)."""

    start_time = 0
    channel_number = '101'
    sample_id = 'simulated'
    sampling_rate = simulate.SAMPLING_RATE
    offset = simulate.OFFSET
    range = simulate.RANGE
    digitisation = simulate.DIGITISATION
    pa_scale = simulate.PA_SCALE

    def __init__(self, read, read_id):
        self.read = read
        self.read_id = read_id
        self.duration = read.duration
        self.run_id = read.run_id

    def get_raw_dac(self):
        return self.read.raw_dac

    def get_raw_data(self):
        return np.asarray(self.range / self.digitisation *
                          (self.read.raw_dac + self.offset), np.float32)

    def get_basecall(self, columns=None):
        from poreplex_torch.fast5 import EventTable
        read = self.read
        names = columns or EVENT_COLUMNS
        return {
            'sequence': read.sequence,
            'qstring': read.qstring,
            'sequence_length': len(read.sequence),
            'mean_qscore': simulate.MEAN_QSCORE,
            'num_events': len(read.events['start']),
            'events': EventTable({n: read.events[n].copy() for n in names}),
        }

    def close(self):
        pass


# what a reader of the pool reports beyond the read itself, as the
# reference takes it
READ_META = dict(pa_scale=PoolReader.pa_scale, offset=PoolReader.offset,
                 sampling_rate=PoolReader.sampling_rate,
                 channel=PoolReader.channel_number,
                 start_time=PoolReader.start_time,
                 sample_id=PoolReader.sample_id,
                 mean_qscore=simulate.MEAN_QSCORE)


class PacedSource:

    holds_files = False

    def __init__(self, pool, seed, batch_size, seconds, lead=LEAD):
        self.pool = pool
        self.seed = seed
        self.batch_size = batch_size
        self.seconds = seconds
        self.lead = lead
        self.cond = threading.Condition()
        self.opened = 0
        self.deadline = None
        self.ended = False
        self.served = {}          # read id -> pool index
        self.batches = []         # pool indices of each listed batch
        self._orders = {}

    @staticmethod
    def filename(k):
        return 'batch{:06d}.fast5'.format(k)

    def start(self):
        """Opens the window: the listing ends ``seconds`` from now."""
        self.deadline = time.perf_counter() + self.seconds

    def order(self, npass):
        if npass not in self._orders:
            rng = np.random.default_rng(seed_sequence(self.seed, 1, npass))
            self._orders[npass] = rng.permutation(len(self.pool))
        return self._orders[npass]

    def list_files(self):
        def names():
            k = 0
            while not self.ended:
                yield self.filename(k)
                k += 1
        return names()

    def read_ids(self, relpath):
        k = int(relpath[5:11])
        with self.cond:
            while self.opened < (k - self.lead) * self.batch_size:
                left = self.deadline - time.perf_counter()
                if left <= 0:
                    break
                self.cond.wait(left)
            if time.perf_counter() >= self.deadline:
                self.ended = True
                return []
        n = len(self.pool)
        entries, indices = [], []
        for g in range(k * self.batch_size, (k + 1) * self.batch_size):
            npass, at = divmod(g, n)
            index = int(self.order(npass)[at])
            read_id = 'p{:04d}-r{:05d}'.format(npass, index)
            self.served[read_id] = index
            entries.append((relpath, read_id))
            indices.append(index)
        self.batches.append(indices)
        return entries

    def exists(self, filename):
        return True

    def opener(self):
        def open_read(filename, read_id):
            with self.cond:
                self.opened += 1
                # the listing waits for whole batches: waking it on every
                # read would take the interpreter lock from PHASE A
                if self.opened % self.batch_size == 0:
                    self.cond.notify_all()
            return PoolReader(self.pool[self.served[read_id]], read_id)
        return open_read

    def snapshot(self):
        return {}


class FixedSource(PacedSource):
    """The given pool indices as one batch, listed at once: the warm-up
    session's source."""

    def __init__(self, pool, indices):
        super().__init__(pool, 0, len(indices), 0)
        self.indices = list(indices)

    def list_files(self):
        return [self.filename(0)]

    def read_ids(self, relpath):
        entries = []
        for index in self.indices:
            read_id = 'w-r{:05d}'.format(index)
            self.served[read_id] = index
            entries.append((relpath, read_id))
        return entries
