"""The window's read source: the surface of ``poreplex_torch``'s
``pipeline.source.MemorySource``, serving a read pool batch by batch.

Each listed file holds one batch of reads. The pool is served in a new
seeded order on each pass, under fresh read ids, so no batch repeats. The
session lists every file at once (``scan_inputs``), so ``read_ids`` paces
the listing: file k is listed once the session has opened the reads of
the first k - LEAD batches, and once the window's seconds have passed the
listing ends and the session finishes the batches in flight. The wait
holds one of the session's monitor threads; the other runs PHASE A.

In a run of several ranks every rank lists the same files and its session
keeps the entries the rank owns (the port's CRC32 split); the source
serves and paces on those alone, so the listing stays LEAD batches ahead
of the rank's own session. With one rank every entry is owned.
"""

import threading
import time
import zlib

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


def owns(relpath, read_id, rank, ranks):
    """Whether rank ``rank`` of ``ranks`` owns the entry: the CRC32 of file
    name and read id, as the port's ``parallel/distributed.owns_entry``
    splits a run's reads."""
    if ranks <= 1:
        return True
    return zlib.crc32((relpath + '\0' + read_id).encode()) % ranks == rank


class PacedSource:

    holds_files = False

    def __init__(self, pool, seed, batch_size, seconds, lead=LEAD, rank=0,
                 ranks=1, on_listed=None):
        self.pool = pool
        self.seed = seed
        self.batch_size = batch_size
        self.seconds = seconds
        self.lead = lead
        self.rank, self.ranks = rank, ranks
        self.on_listed = on_listed    # called with k once file k is listed
        self.cond = threading.Condition()
        self.owned = 0            # owned entries listed
        self.opened = 0           # owned entries opened
        self.deadline = None
        self.ended = False
        self.served = {}          # read id -> pool index, owned entries
        self.index_of = {}        # read id -> pool index, every entry
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

    def file_entries(self, k):
        """[(read id, pool index, owned)] of file k."""
        relpath, n = self.filename(k), len(self.pool)
        out = []
        for g in range(k * self.batch_size, (k + 1) * self.batch_size):
            npass, at = divmod(g, n)
            index = int(self.order(npass)[at])
            read_id = 'p{:04d}-r{:05d}'.format(npass, index)
            out.append((read_id, index,
                        owns(relpath, read_id, self.rank, self.ranks)))
        return out

    def read_ids(self, relpath):
        k = int(relpath[5:11])
        with self.cond:
            # with one rank: until the first k - lead batches are opened
            while self.owned - self.opened > self.lead * self.batch_size:
                left = self.deadline - time.perf_counter()
                if left <= 0:
                    break
                self.cond.wait(left)
            if time.perf_counter() >= self.deadline:
                self.ended = True
                return []
        entries, indices = [], []
        for read_id, index, owned in self.file_entries(k):
            self.index_of[read_id] = index
            entries.append((relpath, read_id))
            if owned:
                self.served[read_id] = index
                indices.append(index)
        with self.cond:
            self.owned += len(indices)
        self.batches.append(indices)
        if self.on_listed is not None:
            self.on_listed(k)
        return entries

    def served_through(self, last):
        """{read id: pool index} of the owned entries of files 0 to
        ``last``: what a rank that listed them was served."""
        return {rid: index for k in range(last + 1)
                for rid, index, owned in self.file_entries(k) if owned}

    def exists(self, filename):
        return True

    def opener(self):
        def open_read(filename, read_id):
            with self.cond:
                if read_id in self.served:
                    self.opened += 1
                    # the listing waits for whole batches: waking it on
                    # every read would take the interpreter lock from
                    # PHASE A
                    if self.opened % self.batch_size == 0:
                        self.cond.notify_all()
            return PoolReader(self.pool[self.index_of[read_id]], read_id)
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
            self.served[read_id] = self.index_of[read_id] = index
            entries.append((relpath, read_id))
        return entries
