"""FAST5 (HDF5) reading: single- and multi-read layouts, raw DAC signal and
its picoampere affine, the basecall group with albacore ``Events`` or
guppy ``Move`` tables (events rebuilt from fixed-stride signal blocks), and
the copy of a read's subtree into a multi-read output file.

h5py is imported only inside the functions that open FAST5 files, so the
rest of the port runs where h5py is not installed; scipy's median filter
only where a guppy table is read, which keeps an ingest worker's start
short.
"""

import ctypes
import os.path

import numpy as np

__all__ = ['get_read_ids', 'Fast5Reader', 'Fast5FilePool', 'EventTable',
           'DuplicatedReadError', 'find_libhdf5', 'dac_to_pa', 'KeptRead']

# the sonames a native FAST5 reader dlopens, in the order poreplex-tpu's
# reader tries them
HDF5_SONAMES = ('libhdf5_serial.so.103', 'libhdf5_serial.so',
                'libhdf5.so.103', 'libhdf5.so')


def find_libhdf5():
    """The first of HDF5_SONAMES that the dynamic loader opens, or None."""
    for soname in HDF5_SONAMES:
        try:
            ctypes.CDLL(soname)
        except OSError:
            continue
        return soname
    return None


def _read_attrs(handle, path, names):
    """Named attributes of one object through the low-level h5py API (the
    high-level attrs proxy costs about 120 us per access)."""
    from h5py import h5a, h5o
    oid = h5o.open(handle.id, path.encode())
    out = []
    for name in names:
        aid = h5a.open(oid, name.encode())
        arr = np.empty(aid.shape, dtype=aid.dtype)
        aid.read(arr)
        out.append(arr[()] if arr.shape == () else arr)
    return out


class EventTable:
    """Column store of basecalled events: a dict of aligned numpy arrays
    with the small table surface the pipeline uses."""

    __slots__ = ('_cols',)

    def __init__(self, cols=None):
        self._cols = {}
        for name, vals in (cols or {}).items():
            self._cols[name] = np.asarray(vals)

    @classmethod
    def from_structured(cls, arr):
        return cls({name: arr[name] for name in arr.dtype.names})

    def __getitem__(self, name):
        return self._cols[name]

    def __setitem__(self, name, vals):
        self._cols[name] = np.asarray(vals)

    def __len__(self):
        for vals in self._cols.values():
            return len(vals)
        return 0

    def copy(self):
        return EventTable(self._cols)


class Fast5FilePool:
    """Refcounted h5py.File handles, so the reads of one multi-read file in
    a batch share one open file. Not thread-safe; one pool per batch."""

    def __init__(self):
        self._files = {}    # path -> [h5py.File, refcount]

    def open(self, path):
        import h5py
        entry = self._files.get(path)
        if entry is None:
            entry = self._files[path] = [h5py.File(path, 'r'), 0]
        entry[1] += 1
        return entry[0]

    def release(self, path):
        entry = self._files.get(path)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            entry[0].close()
            del self._files[path]


class DuplicatedReadError(Exception):
    pass


def get_read_ids(filename, basedir=None):
    """(filename, read_id) pairs contained in a FAST5 file."""
    import h5py
    fast5path = os.path.join(basedir, filename) if basedir else filename

    with h5py.File(fast5path, 'r') as f5:
        if 'UniqueGlobalKey' in f5:
            try:
                first_read = next(iter(f5['Raw/Reads'].values()))
                return [(filename, _decode(first_read.attrs['read_id']))]
            except KeyError:
                return []

        return [(filename, node[5:]) for node in f5
                if node.startswith('read_')]


def dac_to_pa(raw, rng, digitisation, offset):
    """A raw DAC signal in picoamperes, float32: rng / digitisation *
    (raw + offset), evaluated in float64 as poreplex-tpu's
    Fast5Reader.get_raw_data does, so that albacore gets the same array
    bit for bit."""
    return np.asarray(rng / digitisation * (raw + offset), dtype=np.float32)


class KeptRead:
    """A read's raw DAC signal with its reader's calibration and the
    metadata albacore takes (channel, start time in samples, duration,
    sampling rate), kept past PHASE A, when the reader is closed;
    ``get_raw_data`` is the reader's."""

    def __init__(self, reader, raw):
        self.raw = raw
        self.range = reader.range
        self.digitisation = reader.digitisation
        self.offset = reader.offset
        self.channel_number = reader.channel_number
        self.start_time = reader.start_time
        self.duration = reader.duration
        self.sampling_rate = reader.sampling_rate

    def get_raw_data(self):
        return dac_to_pa(self.raw, self.range, self.digitisation,
                         self.offset)


def _decode(value):
    return value.decode() if isinstance(value, bytes) else str(value)


class Fast5Reader:

    RAWSIGNAL_PREFILTER_SIZE = 5  # guppy event reconstruction only

    def __init__(self, path, read_id=None, pool=None):
        import h5py
        self.path = path
        self.read_id = read_id
        self.pool = pool
        self.handle = pool.open(path) if pool is not None else \
            h5py.File(path, 'r')

        self.is_multiread = 'UniqueGlobalKey' not in self.handle
        if self.is_multiread:
            base = 'read_{}'.format(read_id)
            self.read_node = base + '/Raw'
            self.channel_node = base + '/channel_id'
            self.tracking_node = base + '/tracking_id'
            self.analyses_node = base + '/Analyses'
        else:
            first_read = next(iter(self.handle['Raw/Reads'].keys()))
            self.read_node = 'Raw/Reads/' + first_read
            self.channel_node = 'UniqueGlobalKey/channel_id'
            self.tracking_node = 'UniqueGlobalKey/tracking_id'
            self.analyses_node = 'Analyses'

        self._load_metadata()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self.handle is not None:
            if self.pool is not None:
                self.pool.release(self.path)
            else:
                self.handle.close()
            self.handle = None

    def _load_metadata(self):
        duration, start_time, read_id = _read_attrs(
            self.handle, self.read_node,
            ('duration', 'start_time', 'read_id'))
        self.duration = int(duration)
        self.start_time = int(start_time)
        file_read_id = _decode(read_id)
        if self.read_id is None:
            self.read_id = file_read_id
        elif file_read_id != self.read_id:
            raise ValueError('Unexpected read {} found in {}'.format(
                file_read_id, self.path))

        channel, digitisation, offset, rng, rate = _read_attrs(
            self.handle, self.channel_node,
            ('channel_number', 'digitisation', 'offset', 'range',
             'sampling_rate'))
        self.channel_number = _decode(channel)
        self.digitisation = float(digitisation)
        self.offset = float(offset)
        self.range = float(rng)
        self.sampling_rate = float(rate)

        run_id, sample_id = _read_attrs(self.handle, self.tracking_node,
                                        ('run_id', 'sample_id'))
        self.run_id = _decode(run_id)
        self.sample_id = _decode(sample_id)

    @property
    def pa_scale(self):
        """pA per DAC step; pA = pa_scale * (dac + offset)."""
        return self.range / self.digitisation

    def get_raw_dac(self, start=None, end=None):
        """Raw signal slice in instrument DAC units, as stored."""
        signode = self.handle[self.read_node + '/Signal']
        if end is None or end > len(signode):
            end = len(signode)
        start = start or 0
        return signode[start:end]

    def get_raw_data(self, start=None, end=None):
        """Raw signal slice in picoamperes."""
        return dac_to_pa(self.get_raw_dac(start, end), self.range,
                         self.digitisation, self.offset)

    def get_basecall(self, analysis_group='Basecall_1D', columns=None):
        """The newest basecall analysis with its event table, or None.
        ``columns`` restricts an albacore Events read to those members."""
        from h5py import h5a, h5o
        try:
            analnode = self.handle[self.analyses_node]
        except KeyError:
            return None

        groups = [name for name in analnode.keys()
                  if name.startswith(analysis_group)]
        if not groups:
            return None

        analyses = analnode[max(groups)]
        groupno = analyses.name.rsplit('_', 1)[-1]
        summary = {}

        fastqenc = _decode(analyses['BaseCalled_template/Fastq'][()]).split('\n')
        summary['sequence'] = fastqenc[1]
        summary['qstring'] = fastqenc[3]

        num_events, first_sample = _read_attrs(
            analnode, 'Segmentation_{}/Summary/segmentation'.format(groupno),
            ('num_events_template', 'first_sample_template'))
        summary_path = 'Summary/{}_template'.format(analysis_group.lower())
        sequence_length, mean_qscore = _read_attrs(
            analyses, summary_path, ('sequence_length', 'mean_qscore'))
        summary_oid = h5o.open(analyses.id, summary_path.encode())
        if h5a.exists(summary_oid, b'block_stride'):
            stride, = _read_attrs(analyses, summary_path, ('block_stride',))
        else:
            stride = 15
        summary['block_stride'] = int(stride)
        summary['sequence_length'] = int(sequence_length)
        summary['mean_qscore'] = float(mean_qscore)
        summary['num_events'] = int(num_events)
        summary['first_sample_template'] = int(first_sample)

        summary['events'] = self._load_events(analyses, summary, columns)
        return summary

    def _load_events(self, analyses, summary, columns=None):
        if 'BaseCalled_template/Events' in analyses:
            dset = analyses['BaseCalled_template/Events']
            names = dset.dtype.names or ()
            if len(names) <= 3 and 'move' in names:  # guppy-style Events
                return self._reconstruct_guppy_events(
                    EventTable.from_structured(dset[()]), summary)
            if len(names) == 14:  # albacore >= 2.3.0
                if columns:
                    use = tuple(c for c in columns if c in names)
                    return EventTable.from_structured(dset.fields(use)[()])
                return EventTable.from_structured(dset[()])
            raise Exception('Unsupported event table found.')
        elif 'BaseCalled_template/Move' in analyses:
            evdf = self._events_from_moves(analyses, summary)
            return self._reconstruct_guppy_events(evdf, summary)
        raise Exception(
            "Neither `Events' or `Move' table found in the basecall.")

    def _events_from_moves(self, analyses, summary):
        """A minimal event table from a guppy Move table, with flip-flop
        1-mer -> 5-mer reframing: classic models emit (seqlen - 4) 5-mers
        centred at +2, flip-flop models one base per move (the window is
        completed by padding both ends with ``__``)."""
        moves = analyses['BaseCalled_template/Move'][()]
        pos = (moves.cumsum() - 1).astype(np.int64)
        kmer_size = len(summary['sequence']) - int(moves.sum()) + 1
        revseq = summary['sequence'][::-1].replace('U', 'T')

        if kmer_size == 5:
            center_offset = 2
        elif kmer_size == 1:
            revseq = '__' + revseq + '__'
            center_offset = 0
        else:
            raise Exception('Move table is encoded with an unknown kmer-size.')

        seqbuf = np.frombuffer(revseq.encode(), dtype='S1')
        window = pos[:, None] + np.arange(5)
        kmers = (seqbuf[np.minimum(window, len(seqbuf) - 1)]
                 .view('S5').ravel().astype('U5'))

        base_qual = 1.0 - np.power(
            10.0, -(np.frombuffer(summary['qstring'].encode(), 'B') - 33) / 10)

        return EventTable({
            'model_state': kmers,
            'p_model_state': base_qual[pos + center_offset],
            'move': moves,
        })

    def _reconstruct_guppy_events(self, events, summary):
        """Per-event start/mean/stdv/length from fixed-stride raw signal
        blocks after a median prefilter; a truncated final block is
        completed with NaN so its statistics flag the truncation."""
        stride = summary['block_stride']
        first = summary['first_sample_template']
        nblocks = len(events)

        from scipy.signal import medfilt
        filtered = medfilt(self.get_raw_data(first, first + stride * nblocks),
                           self.RAWSIGNAL_PREFILTER_SIZE)
        if -(-len(filtered) // stride) != nblocks:
            raise Exception(
                'Numbers of events and raw data strides does not match.')
        blocks = np.full(nblocks * stride, np.nan)
        blocks[:len(filtered)] = filtered
        blocks = blocks.reshape(nblocks, stride)

        events['start'] = first + stride * np.arange(nblocks)
        events['mean'] = blocks.mean(axis=1)
        events['stdv'] = blocks.std(axis=1)
        events['length'] = stride
        return events

    def copyto(self, dstfile):
        """Copy this read's subtree into an open multi-read output file as
        ``read_<id>``; a read already there raises DuplicatedReadError."""
        nodepath = 'read_' + self.read_id

        if self.is_multiread:
            try:
                dstfile.copy(self.handle[nodepath], dstfile, nodepath)
                return
            except (RuntimeError, ValueError) as exc:
                if 'already exists' in str(exc):
                    raise DuplicatedReadError(str(exc))
                raise

        if nodepath in dstfile:
            raise DuplicatedReadError(
                "Duplicated read '{}' found.".format(self.read_id))

        dstgrp = dstfile.create_group(nodepath)
        dstgrp.attrs['run_id'] = self.run_id
        dstgrp.copy(self.handle[self.read_node], 'Raw')
        for grpname, grpobj in self.handle['UniqueGlobalKey'].items():
            dstgrp.copy(grpobj, dstgrp, grpname)
        for grpname, grpobj in self.handle.items():
            if grpname not in ('Raw', 'UniqueGlobalKey'):
                dstgrp.copy(grpobj, grpname)
