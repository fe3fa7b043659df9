"""Output writers with upstream poreplex's formats: per-(label, barcode)
BGZF FASTQ streams with adapter trimming, sequencing_summary.txt, and the
end-of-run count matrix by label x status x barcode."""

import logging
import os
from collections import defaultdict
from functools import partial
from threading import Lock

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
