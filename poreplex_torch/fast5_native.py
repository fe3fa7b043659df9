"""ctypes binding of the native FAST5 reader (``csrc/fast5_ingest.cc``).

The PHASE A ingest workers (``pipeline/ingest.py``) read a read's metadata
attributes, raw DAC signal and albacore event columns through the HDF5 C
API, one C call per logical operation, in place of h5py's per-object
Python proxies. A guppy Move table, a full-table event dump, an exotic
layout and any native error make the worker read that read through h5py
instead (``None`` or ``'fallback'`` here).

The library is host C++ built with g++ at first use into
``build/poreplex_torch_native/``, named by a hash of its source and flags
(as ``kernels/_build.py`` names the CUDA libraries), and dlopens libhdf5
at run time: the system's sonames of ``fast5.HDF5_SONAMES`` first, which
keeps its state apart from h5py's bundled copy, then that copy.
"""

import ctypes
import glob
import hashlib
import os
import subprocess

import numpy as np

from .fast5 import HDF5_SONAMES, EventTable

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(PACKAGE_DIR, 'csrc', 'fast5_ingest.cc')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build',
                         'poreplex_torch_native')
FLAGS = ['-O3', '-fPIC', '-std=c++17', '-shared']

# the memory layout of one event row, struct EventRow of the source
EVENT_DTYPE = np.dtype([('mean', '<f8'), ('p_model_state', '<f8'),
                        ('start', '<u8'), ('move', '<i8'),
                        ('model_state', 'S8')])
assert EVENT_DTYPE.itemsize == 40

_STR_CAP = 256
_lib = None
_lib_tried = False

# per-process scratch reused across reads (an ingest worker reads on one
# thread): a fresh 5 MB event buffer a read would cost more than the read
_EVENT_BUF = None
_FASTQ_BUF = None


def _event_scratch(max_events):
    global _EVENT_BUF
    if _EVENT_BUF is None or len(_EVENT_BUF) < max_events:
        _EVENT_BUF = np.empty(max_events, EVENT_DTYPE)
    return _EVENT_BUF


def _fastq_scratch(cap):
    global _FASTQ_BUF
    if _FASTQ_BUF is None or ctypes.sizeof(_FASTQ_BUF) < cap:
        _FASTQ_BUF = ctypes.create_string_buffer(cap)
    return _FASTQ_BUF


def hdf5_candidates():
    """Paths or sonames of libhdf5 to dlopen, in the order tried."""
    yield from HDF5_SONAMES
    try:
        import h5py
    except ImportError:
        return
    libsdir = os.path.join(os.path.dirname(os.path.dirname(h5py.__file__)),
                           'h5py.libs')
    yield from sorted(glob.glob(os.path.join(libsdir, 'libhdf5-*.so*')))


def library_path():
    with open(SOURCE, 'rb') as f:
        text = f.read()
    key = hashlib.sha256(text + ' '.join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, 'fast5_ingest-{}.so'.format(key))


def build_library():
    """Compile the source unless its library exists; returns the library's
    path. Several worker processes may build at once: each compiles to a
    private name and renames it into place atomically."""
    target = library_path()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    partial = '{}.{}.tmp'.format(target, os.getpid())
    try:
        subprocess.run(['g++'] + FLAGS + ['-o', partial, SOURCE, '-ldl'],
                       check=True, capture_output=True, text=True)
        os.replace(partial, target)
    finally:
        if os.path.exists(partial):
            os.unlink(partial)
    return target


def get_library():
    """The loaded library with libhdf5 resolved, or None where it cannot
    be built or no libhdf5 opens (the worker then reads through h5py)."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(build_library())
    except (OSError, subprocess.CalledProcessError):
        return None

    c_ll = ctypes.c_longlong
    lib.f5i_init.argtypes = [ctypes.c_char_p]
    lib.f5i_init.restype = ctypes.c_int
    lib.f5i_available.argtypes = []
    lib.f5i_available.restype = ctypes.c_int
    lib.f5i_open.argtypes = [ctypes.c_char_p]
    lib.f5i_open.restype = ctypes.c_int64
    lib.f5i_close.argtypes = [ctypes.c_int64]
    lib.f5i_close.restype = ctypes.c_int
    lib.f5i_exists.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.f5i_exists.restype = ctypes.c_int
    lib.f5i_first_child.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.f5i_first_child.restype = ctypes.c_int
    lib.f5i_list_children.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                      ctypes.c_char_p, c_ll]
    lib.f5i_list_children.restype = c_ll
    lib.f5i_read_meta.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(c_ll),
        ctypes.c_char_p, ctypes.c_int]
    lib.f5i_read_meta.restype = ctypes.c_int
    lib.f5i_read_signal_i16.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                        ctypes.c_void_p, c_ll]
    lib.f5i_read_signal_i16.restype = c_ll
    lib.f5i_read_string_dataset.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                            ctypes.c_char_p, c_ll]
    lib.f5i_read_string_dataset.restype = c_ll
    lib.f5i_read_events.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_void_p, c_ll,
                                    ctypes.POINTER(c_ll),
                                    ctypes.POINTER(c_ll)]
    lib.f5i_read_events.restype = c_ll
    lib.f5i_read_attr_f64.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                      ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_double)]
    lib.f5i_read_attr_f64.restype = ctypes.c_int
    lib.f5i_read_attr_i64.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.POINTER(c_ll)]
    lib.f5i_read_attr_i64.restype = ctypes.c_int
    lib.f5i_attr_exists.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_char_p]
    lib.f5i_attr_exists.restype = ctypes.c_int

    for cand in hdf5_candidates():
        if lib.f5i_init(cand.encode()) == 0:
            _lib = lib
            return _lib
    return None


class NativeFast5:
    """One open FAST5 file, shared by the reads of a batch's chunk as
    fast5.Fast5FilePool shares h5py handles."""

    def __init__(self, lib, fid, path):
        self.lib = lib
        self.fid = fid
        self.path = path
        self.is_multiread = lib.f5i_exists(fid, b'UniqueGlobalKey') == 0

    @classmethod
    def open(cls, path):
        """The open file, or None where the library or the file cannot be
        opened."""
        lib = get_library()
        if lib is None:
            return None
        fid = lib.f5i_open(path.encode())
        if fid < 0:
            return None
        return cls(lib, fid, path)

    def close(self):
        if self.fid is not None:
            self.lib.f5i_close(self.fid)
            self.fid = None

    def list_children(self, group, cap=1 << 14):
        """Child link names of a group, or None on failure (group missing
        or unreadable, a name not UTF-8, or the buffer too small)."""
        buf = ctypes.create_string_buffer(cap)
        n = self.lib.f5i_list_children(self.fid, group.encode(), buf, cap)
        if n < 0:
            return None
        try:
            return [name.decode() for name in buf.raw[:n].split(b'\0')[:-1]]
        except UnicodeDecodeError:
            return None

    def nodes_for(self, read_id):
        """(raw, channel, tracking, signal, analyses) node paths, or None
        when the layout cannot be resolved."""
        if self.is_multiread:
            base = 'read_' + read_id
            if not self.lib.f5i_exists(self.fid, base.encode()):
                return None
            return (base + '/Raw', base + '/channel_id',
                    base + '/tracking_id', base + '/Raw/Signal',
                    base + '/Analyses')
        buf = ctypes.create_string_buffer(_STR_CAP)
        if self.lib.f5i_first_child(self.fid, b'Raw/Reads', buf,
                                    _STR_CAP) != 0:
            return None
        raw = 'Raw/Reads/' + buf.value.decode()
        return (raw, 'UniqueGlobalKey/channel_id',
                'UniqueGlobalKey/tracking_id', raw + '/Signal', 'Analyses')

    def read_meta(self, raw_node, channel_node, tracking_node):
        dbl4 = (ctypes.c_double * 4)()
        i64_2 = (ctypes.c_longlong * 2)()
        strbuf = ctypes.create_string_buffer(4 * _STR_CAP)
        rc = self.lib.f5i_read_meta(
            self.fid, raw_node.encode(), channel_node.encode(),
            tracking_node.encode(), dbl4, i64_2, strbuf, _STR_CAP)
        if rc != 0:
            return None

        def text(i):
            return strbuf[i * _STR_CAP:(i + 1) * _STR_CAP].split(b'\0')[0] \
                .decode()
        return {
            'digitisation': dbl4[0], 'offset': dbl4[1], 'range': dbl4[2],
            'sampling_rate': dbl4[3],
            'duration': int(i64_2[0]), 'start_time': int(i64_2[1]),
            'read_id': text(0), 'channel_number': text(1),
            'run_id': text(2), 'sample_id': text(3),
        }

    def read_signal(self, signal_path, expect):
        """Raw DAC as int16, or None; ``expect`` (the read's duration
        attribute) sizes the buffer, which is sized again from the
        dataset when that is longer."""
        cap = max(int(expect), 1)
        for _ in range(2):
            buf = np.empty(cap, np.int16)
            n = self.lib.f5i_read_signal_i16(
                self.fid, signal_path.encode(),
                buf.ctypes.data_as(ctypes.c_void_p), cap)
            if n >= 0:
                return buf[:n] if n < cap else buf
            if n != -4:         # not a buffer too small
                return None
            cap = int(self.lib.f5i_read_signal_i16(
                self.fid, signal_path.encode(), None, 0))
            if cap <= 0:
                return None
        return None

    def read_basecall(self, analyses_node, max_events=1 << 17,
                      fastq_cap=1 << 22):
        """The basecall dict of fast5.Fast5Reader.get_basecall with the
        event columns the pipeline reads, None when the read has no
        basecall, or 'fallback' when it has one that only the h5py reader
        reads (guppy Move tables, other layouts, oversized tables)."""
        lib = self.lib
        if lib.f5i_exists(self.fid, analyses_node.encode()) != 1:
            return None             # no Analyses group: not basecalled
        # the h5py reader's pick: the greatest child name that starts
        # with 'Basecall_1D'
        kids = self.list_children(analyses_node)
        if kids is None:
            return 'fallback'
        groups = [k for k in kids if k.startswith('Basecall_1D')]
        if not groups:
            return None
        groupno = max(groups).rsplit('_', 1)[-1]
        if len(groupno) != 3 or not groupno.isdigit():
            return 'fallback'
        group = '{}/{}'.format(analyses_node, max(groups))

        events_path = group + '/BaseCalled_template/Events'
        if lib.f5i_exists(self.fid, events_path.encode()) != 1:
            return 'fallback'       # guppy Move encoding
        nmem = ctypes.c_longlong(0)
        ssize = ctypes.c_longlong(5)
        rows = _event_scratch(max_events)
        n = lib.f5i_read_events(self.fid, events_path.encode(),
                                rows.ctypes.data_as(ctypes.c_void_p),
                                max_events, ctypes.byref(nmem),
                                ctypes.byref(ssize))
        if n < 0 or nmem.value != 14:
            # only albacore's 14-column table is read here; the h5py
            # reader decides on every other one
            return 'fallback'

        fastq = _fastq_scratch(fastq_cap)
        fq_n = lib.f5i_read_string_dataset(
            self.fid, (group + '/BaseCalled_template/Fastq').encode(),
            fastq, fastq_cap)
        if fq_n < 0:
            return 'fallback'
        fastqenc = fastq.value.decode().split('\n')
        if len(fastqenc) < 4:
            return 'fallback'

        segnode = '{}/Segmentation_{}/Summary/segmentation'.format(
            analyses_node, groupno).encode()
        sumnode = (group + '/Summary/basecall_1d_template').encode()
        num_events = ctypes.c_longlong(0)
        first_sample = ctypes.c_longlong(0)
        seqlen = ctypes.c_longlong(0)
        qscore = ctypes.c_double(0)
        if (lib.f5i_read_attr_i64(self.fid, segnode, b'num_events_template',
                                  ctypes.byref(num_events)) != 0 or
                lib.f5i_read_attr_i64(self.fid, segnode,
                                      b'first_sample_template',
                                      ctypes.byref(first_sample)) != 0 or
                lib.f5i_read_attr_i64(self.fid, sumnode, b'sequence_length',
                                      ctypes.byref(seqlen)) != 0 or
                lib.f5i_read_attr_f64(self.fid, sumnode, b'mean_qscore',
                                      ctypes.byref(qscore)) != 0):
            return 'fallback'
        stride = ctypes.c_longlong(15)
        if lib.f5i_attr_exists(self.fid, sumnode, b'block_stride') == 1:
            lib.f5i_read_attr_i64(self.fid, sumnode, b'block_stride',
                                  ctypes.byref(stride))

        rows = rows[:n]
        # the columns are copied out of the reused scratch buffer
        events = EventTable({
            'mean': rows['mean'].copy(),
            'start': rows['start'].copy(),
            'move': rows['move'].copy(),
            'p_model_state': rows['p_model_state'].copy(),
            'model_state': rows['model_state'].astype(
                'S{}'.format(max(1, int(ssize.value)))),
        })
        return {
            'sequence': fastqenc[1],
            'qstring': fastqenc[3],
            'block_stride': int(stride.value),
            'sequence_length': int(seqlen.value),
            'mean_qscore': float(qscore.value),
            'num_events': int(num_events.value),
            'first_sample_template': int(first_sample.value),
            'events': events,
        }
