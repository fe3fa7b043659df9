"""Output writers with upstream poreplex's formats: per-(label, barcode)
BGZF FASTQ streams with adapter trimming, rotated multi-read FAST5 copies,
sequencing_summary.txt, the nanopolish FASTA and readdb, the adapter-signal
and basecalled-event dumps with their end-of-run inventories, and the
end-of-run count matrix by label x status x barcode.

h5py is imported only inside the functions that write HDF5 files."""

import logging
import os
from collections import defaultdict
from functools import partial
from glob import glob
from threading import Lock

import numpy as np

from .. import OUTPUT_NAME_FAILED
from ..fast5 import Fast5Reader, DuplicatedReadError
from ..utils import ensure_dir_exists
from .bgzf import BGZFWriter


class FASTQWriter:

    def __init__(self, output_dir, output_layout):
        self.output_dir = output_dir
        self.output_layout = output_layout
        self.lock = Lock()
        self.streams = {
            int_name: BGZFWriter(self.get_output_path(name))
            for int_name, name in output_layout.items()}

    def get_output_path(self, name):
        output_path = os.path.join(self.output_dir, 'fastq',
                                   name + '.fastq.gz')
        ensure_dir_exists(output_path)
        return output_path

    def close(self):
        for stream in self.streams.values():
            stream.close()

    def write_sequences(self, procresult):
        with self.lock:
            for entry in procresult:
                if entry.get('sequence') is not None:
                    seq, qual, adapter_length = entry['sequence']
                    if adapter_length > 0:
                        seq = seq[:-adapter_length]
                        qual = qual[:-adapter_length]
                    output_name = entry['label'], entry.get('barcode')
                    formatted = '@{}\n{}\n+\n{}\n'.format(
                        entry['read_id'], seq, qual)
                    self.streams[output_name].write(formatted)


class _RotatingFast5Series:
    """One (label, barcode) stream of multi-read FAST5 files: a new
    ``<name>_<k>.fast5`` is opened lazily and rolled over every
    ``reads_per_file`` reads."""

    def __init__(self, path_template, reads_per_file):
        self.path_template = path_template
        self.reads_per_file = reads_per_file
        self.handle = None
        self.fileno = 0
        self.reads_in_file = 0

    def current(self):
        import h5py
        if self.handle is None or self.reads_in_file >= self.reads_per_file:
            self.close()
            self.handle = h5py.File(self.path_template.format(self.fileno),
                                    'w')
            self.fileno += 1
            self.reads_in_file = 0
        self.reads_in_file += 1
        return self.handle

    def close(self):
        if self.handle is not None:
            self.handle.close()
            self.handle = None


class FAST5Writer:
    """Multi-read FAST5 repacking, one rotating file series per output
    name."""

    def __init__(self, output_dir, output_layout, input_dir, batch_size=4000):
        self.input_dir = input_dir
        self.lock = Lock()
        self.series = {}
        for int_name, name in output_layout.items():
            template = os.path.join(output_dir, 'fast5',
                                    name + '_{}.fast5')
            ensure_dir_exists(template)
            self.series[int_name] = _RotatingFast5Series(template, batch_size)

    def close(self):
        for series in self.series.values():
            series.close()

    def transfer_reads(self, procresult):
        with self.lock:
            for entry in procresult:
                output_name = (entry.get('label', OUTPUT_NAME_FAILED),
                               entry.get('barcode'))
                input_name = os.path.join(self.input_dir, entry['filename'])
                try:
                    reader = Fast5Reader(input_name, entry['read_id'])
                except Exception:
                    continue       # vanished or corrupt input: skipped
                try:
                    reader.copyto(self.series[output_name].current())
                except DuplicatedReadError:
                    pass
                finally:
                    reader.close()


class SequencingSummaryWriter:

    SUMMARY_OUTPUT_FIELDS = [
        'filename', 'read_id', 'run_id', 'channel', 'start_time',
        'duration', 'num_events', 'sequence_length', 'mean_qscore',
        'sample_id', 'status', 'label',
    ]

    def __init__(self, config, output_dir, label_mapping, barcode_mapping):
        self.file = open(os.path.join(output_dir, 'sequencing_summary.txt'),
                         'w')
        self.lock = Lock()
        self.label_mapping = label_mapping
        self.output_fields = self.SUMMARY_OUTPUT_FIELDS[:]
        if config['barcoding']:
            self.barcode_mapping = barcode_mapping
            self.output_fields.extend(['barcode', 'barcode_score'])
        else:
            self.barcode_mapping = None
        self.polya_enabled = bool(config['measure_polya'])
        if self.polya_enabled:
            self.output_fields.append('polya_dwell')

        # with FAST5 output the filename column points into fast5/
        if config['fast5_output']:
            if config['barcoding']:
                self.format_filename = (lambda entry: os.path.join(
                    'fast5', entry['label'],
                    self.barcode_mapping[entry.get('barcode')],
                    entry['filename']))
            else:
                self.format_filename = (lambda entry: os.path.join(
                    'fast5', entry['label'], entry['filename']))
        else:
            self.format_filename = lambda entry: entry['filename']

        print(*self.output_fields, sep='\t', file=self.file)

    def close(self):
        self.file.close()

    def write_results(self, results):
        with self.lock:
            for entry in results:
                if 'label' not in entry:
                    continue
                output_entry = entry.copy()
                output_entry['label'] = self.label_mapping[entry['label']]
                output_entry['filename'] = self.format_filename(output_entry)
                if self.barcode_mapping is not None:
                    output_entry['barcode'] = \
                        self.barcode_mapping[entry.get('barcode')]
                    output_entry['barcode_score'] = \
                        entry.get('barcode_score', 0)
                if self.polya_enabled:
                    output_entry['polya_dwell'] = (
                        format(entry['polya']['dwell_time'], '.4f')
                        if 'polya' in entry else '')
                print(*[output_entry[f] for f in self.output_fields],
                      file=self.file, sep='\t')


class NanopolishReadDBWriter:
    """Per output name a FASTA of the sequences and a readdb of read id to
    FAST5 copy; on close each non-empty FASTA is also written BGZF
    compressed as ``.fasta.index``, indexed with pysam's faidx where pysam
    is installed."""

    def __init__(self, output_dir, output_layout):
        self.output_layout = output_layout
        self.output_dir = os.path.join(output_dir, 'nanopolish')
        self.lock = Lock()
        self.seqfiles, self.dbfiles = {}, {}
        for groupid, name in output_layout.items():
            filepath = os.path.join(self.output_dir, name + '.fasta')
            ensure_dir_exists(filepath)
            self.seqfiles[groupid] = open(filepath, 'w')
            self.dbfiles[groupid] = open(filepath + '.index.readdb', 'w')

    def close(self):
        for f in list(self.seqfiles.values()) + list(self.dbfiles.values()):
            f.close()
        self.seqfiles.clear()
        self.dbfiles.clear()

        for groupid, name in self.output_layout.items():
            inputfile = os.path.join(self.output_dir, name + '.fasta')
            if os.path.getsize(inputfile) > 0:
                bgzipped = inputfile + '.index'
                with open(inputfile, 'rb') as src, \
                        BGZFWriter(bgzipped) as dst:
                    dst.write(src.read())
                try:
                    from pysam import faidx
                    faidx(bgzipped)
                except ImportError:
                    pass

    def write_sequences(self, procresult):
        with self.lock:
            for entry in procresult:
                if entry.get('sequence') is not None:
                    mappingkey = entry['label'], entry.get('barcode')
                    self.seqfiles[mappingkey].write(
                        '>{}\n{}\n'.format(entry['read_id'],
                                           entry['sequence'][0]))
                    fast5_relpath = os.path.join(
                        'fast5', self.output_layout[mappingkey],
                        entry['filename'])
                    self.dbfiles[mappingkey].write(
                        '{}\t{}\n'.format(entry['read_id'], fast5_relpath))


class FinalSummaryTracker:
    """End-of-run count matrix by label x status x barcode."""

    REPORTING_ORDER = ['pass', 'artifact', 'fail']
    FRIENDLY_LABELS = {
        'pass': 'Successfully processed',
        'fail': 'Processing failed',
        'artifact': 'Possible artifact',
    }
    FRIENDLY_STATUS = {
        'fail': {
            'scaler_signal_too_short': 'Signal is too short',
            'sequence_too_short': 'Sequence is too short',
            'irregular_fast5': 'Invalid FAST5 format',
            'basecall_table_incomplete': 'Basecall table does not match',
            'adapter_not_detected': "3' Adapter could not be located",
            'not_basecalled': 'No albacore basecall data found',
            'scaling_qc_fail': 'Signal scaling QC failed',
            'disappeared': 'File is moved to other location',
            'unknown_error': 'File could not be opened due to unknown error',
        },
        'artifact': {
            'unsplit_read': 'Two or more molecules found within a read',
        },
    }

    LABEL_FORMAT = '{:49s} '
    LABEL_BULLET = ' - '
    MINIMUM_COLUMN_WIDTH = 3

    def __init__(self, label_names, barcode_names):
        self.label_names = label_names
        self.barcode_names = barcode_names
        self.counts = defaultdict(int)
        self.label_reporting_order = self.REPORTING_ORDER
        self.barcode_reporting_order = sorted(
            [n for n in barcode_names.keys() if n is not None]) + [None]

    def feed_results(self, results):
        for entry in results:
            self.counts[entry.get('label', 'fail'),
                        entry.get('barcode', None),
                        entry['status']] += 1

    def _grouped_rows(self):
        """One row per (label, status): {barcode: count} cells, ordered by
        label, then by the row's largest cell."""
        rows = {}
        for (label, barcode, status), cnt in self.counts.items():
            cells = rows.setdefault((label, status), {})
            cells[barcode] = cells.get(barcode, 0) + cnt
        order = sorted(rows,
                       key=lambda key: (self.label_reporting_order.index(
                           key[0]), -max(rows[key].values())))
        return [(label, status, rows[label, status])
                for label, status in order]

    def print_results(self, file):
        if hasattr(file, 'write'):
            emit = partial(print, sep='\t', file=file)
        else:
            logger = logging.getLogger('poreplex_torch')
            emit = lambda *args: logger.error(' '.join(map(str, args)))

        emit('==== Result Summary ====')
        if not self.counts:
            emit('(no reads processed)')
            return
        width = max(self.MINIMUM_COLUMN_WIDTH,
                    len(str(max(self.counts.values()))))
        cell = '{{:{}}} '.format(width)

        if len(self.barcode_names) > 1:
            emit(self.LABEL_FORMAT.format('') +
                 ''.join(cell.format(self.barcode_names[bc])
                         for bc in self.barcode_reporting_order))

        seen_labels = set()
        for label, status, cells in self._grouped_rows():
            itemized = label in self.FRIENDLY_STATUS
            if label not in seen_labels:
                seen_labels.add(label)
                if itemized:      # a bare heading, statuses bulleted below
                    emit(self.LABEL_FORMAT.format(self.FRIENDLY_LABELS[label]))
            if itemized:
                rowname = (self.LABEL_BULLET +
                           self.FRIENDLY_STATUS[label][status])
            else:                 # 'pass': counts sit on the heading line
                rowname = self.FRIENDLY_LABELS[label]
            emit(self.LABEL_FORMAT.format(rowname) +
                 ''.join(cell.format(cells.get(bc, 0))
                         for bc in self.barcode_reporting_order))
        emit('')


class DumpWriter:
    """Adapter-signal and basecalled-event dumps of a session, written per
    batch into one part file each and linked into inventories at the
    end."""

    EVENT_DUMP_FIELDS = ['mean', 'start', 'stdv', 'length', 'model_state',
                         'move', 'pos', 'end', 'scaled_mean']
    EVENT_DUMP_DTYPES = ['<f4', '<u8', '<f4', '<u8', None,
                         '<i4', '<u8', '<u8', '<f8']

    def __init__(self, config, session_tag='0'):
        import h5py
        self.config = config
        self.outputdir = config['outputdir']
        self.lock = Lock()
        self.adapter_file = self.adapter_catalog = None
        self.events_file = None
        self.kmersize = 5

        if config['dump_adapter_signals']:
            path = os.path.join(self.outputdir, 'adapter-dumps',
                                'part-' + session_tag + '.h5')
            ensure_dir_exists(path)
            self.adapter_file = h5py.File(path, 'a')
            self.adapter_catalog = []
        if config['dump_basecalls']:
            path = os.path.join(self.outputdir, 'events',
                                'part-' + session_tag + '.h5')
            ensure_dir_exists(path)
            self.events_file = h5py.File(path, 'a')

    def write_aux(self, batchid, aux):
        with self.lock:
            fmt_batch = format(batchid, '08d')
            if self.adapter_file is not None:
                grp = self.adapter_file.require_group(
                    'adapter/' + fmt_batch)
                for read_id, signal, start, end in aux['adapter_dumps']:
                    if read_id in grp:
                        continue
                    grp.create_dataset(read_id, shape=(len(signal),),
                                       dtype=np.float32, data=signal)
                    self.adapter_catalog.append((read_id, start, end,
                                                 fmt_batch))
            if self.events_file is not None:
                grp = self.events_file.require_group(
                    'basecalled_events/' + fmt_batch)
                for read_id, events, attrs in aux['event_dumps']:
                    if read_id in grp:
                        continue
                    fields = list(zip(
                        self.EVENT_DUMP_FIELDS,
                        [d if d else 'S{}'.format(self.kmersize)
                         for d in self.EVENT_DUMP_DTYPES]))
                    dataset = np.empty(len(events), dtype=fields)
                    for name, _ in fields:
                        dataset[name] = events[name]
                    grp[read_id] = dataset
                    objattrs = grp[read_id].attrs
                    for attrname, attrvalue in attrs:
                        objattrs[attrname] = attrvalue

    def close(self):
        with self.lock:
            if self.adapter_file is not None:
                by_batch = defaultdict(list)
                for read_id, start, end, fmt_batch in self.adapter_catalog:
                    by_batch[fmt_batch].append((read_id, start, end))
                catgrp = self.adapter_file.require_group('catalog/adapter')
                for fmt_batch, entries in by_batch.items():
                    encoded = np.array(entries, dtype=[
                        ('read_id', 'S36'), ('start', 'i8'), ('end', 'i8')])
                    catgrp.create_dataset(fmt_batch, shape=encoded.shape,
                                          data=encoded)
                self.adapter_file.close()
                self.adapter_file = None
            if self.events_file is not None:
                self.events_file.close()
                self.events_file = None


# ---------------------------------------------------------------- merges

def get_read_id_dump_group(read_id, grplength=3):
    return read_id[:grplength]


def create_links_rebalanced(desth5, group, infiles):
    """Link every read of ``group`` in the part files into desth5, under
    subgroups named by the read id's first characters."""
    import h5py
    desth5.require_group(group)
    for datafile in infiles:
        basename = os.path.basename(datafile)
        with h5py.File(datafile, 'r') as d5:
            if group not in d5:
                continue
            for batchid, subgrp in d5[group].items():
                for readid in subgrp.keys():
                    dumpgroup = get_read_id_dump_group(readid)
                    gobj = desth5.require_group(group + '/' + dumpgroup)
                    if readid in gobj:
                        continue
                    gobj[readid] = h5py.ExternalLink(
                        basename, '{}/{}/{}'.format(group, batchid, readid))


def create_adapter_dumps_inventory(destfile, filepattern):
    """The adapter dumps' inventory: the part files' catalogs merged and
    sorted by read id, and a link to every dump."""
    import h5py
    with h5py.File(destfile, 'w') as ivt:
        ivt.require_group('catalog')
        fragments = []
        for datafile in glob(filepattern):
            with h5py.File(datafile, 'r') as d5:
                if 'catalog/adapter' not in d5:
                    continue
                for batchid, tbl in d5['catalog/adapter'].items():
                    fragments.append(tbl[:])
        if fragments:
            fulltbl = np.hstack(fragments)
            fulltbl.sort(order='read_id')
            ivt['catalog/adapter'] = fulltbl
        create_links_rebalanced(ivt, 'adapter', glob(filepattern))


def create_events_inventory(destfile, filepattern):
    """The basecalled events' inventory: a link to every read's table."""
    import h5py
    with h5py.File(destfile, 'w') as ivt:
        create_links_rebalanced(ivt, 'basecalled_events', glob(filepattern))
