"""Offline processing session: scan an input directory tree for FAST5
files, run the reads through the BatchAnalyzer in batches of
``batch_chunk_size``, and write the FASTQ streams, the sequencing summary
and the final count matrix.

Batches run one after another in this process; the device works on one
batch at a time. Live mode, the dashboard, resume and multi-host runs
belong to later slices of the port (``config.LATER_SLICES``).
"""

import os
from collections import defaultdict

from ..fast5 import get_read_ids
from ..io.writers import (FASTQWriter, SequencingSummaryWriter,
                          FinalSummaryTracker)
from ..utils import errprint, GLOBAL_TIMER
from .analyzer import BatchAnalyzer

FAST5_SUFFIX = '.fast5'


def scan_dir(topdir, dirname='', suffix=FAST5_SUFFIX):
    """Paths, relative to topdir, of every FAST5 file under it: a
    directory's files (in listing order) before its subdirectories."""
    files, dirs = [], []
    for entryname in os.listdir(os.path.join(topdir, dirname)):
        if entryname.startswith('.'):
            continue
        relpath = os.path.join(dirname, entryname)
        if os.path.isdir(os.path.join(topdir, relpath)):
            dirs.append(relpath)
        elif entryname.lower().endswith(suffix):
            files.append(relpath)
    yield from files
    for relpath in dirs:
        yield from scan_dir(topdir, relpath, suffix)


class ProcessingSession:

    def __init__(self, config, logger):
        self.config = config
        self.logger = logger
        self.reads_found = 0
        self.reads_processed = 0
        self.reads_done = set()
        self.status_counts = defaultdict(int)
        self.analyzer = None
        self.fastq_writer = None
        self.seqsummary_writer = None
        self.finalsummary_tracker = None

    def __enter__(self):
        config = self.config
        if config['fastq_output']:
            self.fastq_writer = FASTQWriter(config['outputdir'],
                                            config['output_layout'])
        self.seqsummary_writer = SequencingSummaryWriter(
            config, config['outputdir'], config['label_names'],
            config['barcode_names'])
        self.finalsummary_tracker = FinalSummaryTracker(
            config['label_names'], config['barcode_names'])
        return self

    def __exit__(self, *args):
        for writer in (self.fastq_writer, self.seqsummary_writer):
            if writer is not None:
                writer.close()
        self.fastq_writer = self.seqsummary_writer = None

    def show_message(self, message):
        if not self.config['quiet']:
            print(message)

    def entries(self):
        """Read entries in scan order; a file that cannot be listed is
        logged and skipped."""
        topdir = self.config['inputdir']
        for relpath in scan_dir(topdir):
            try:
                yield from get_read_ids(relpath, topdir)
            except Exception as exc:
                self.logger.error('Could not list reads in %s: %s',
                                  relpath, exc)

    def process_batch(self, batch):
        """Run one batch and write its results; returns False when the
        session must stop."""
        results = self.analyzer.process_batch(batch)
        fresh = []
        for result in results:
            readpath = result['filename'], result['read_id']
            if readpath in self.reads_done:
                self.reads_found -= 1
                continue
            if result['status'] == 'okay':
                self.reads_done.add(readpath)
            elif 'error_message' in result:
                self.logger.error(result['error_message'])
            self.status_counts[result['status']] += 1
            fresh.append(result)
        if fresh:
            if self.fastq_writer is not None:
                with GLOBAL_TIMER.stage('D:io_fastq'):
                    self.fastq_writer.write_sequences(fresh)
            with GLOBAL_TIMER.stage('D:io_summary'):
                self.seqsummary_writer.write_results(fresh)
            self.finalsummary_tracker.feed_results(fresh)
        self.reads_processed += len(fresh)

        # a stream of reads without basecalls: stop early
        if (self.status_counts['okay'] == 0 and
                self.status_counts['not_basecalled'] >=
                self.config['nobasecall_stop_trigger']):
            stopmsg = (
                'Early stopping: {} out of {} reads are not basecalled. '
                'Please check if the files are correctly analyzed.'.format(
                    self.status_counts['not_basecalled'],
                    sum(self.status_counts.values())))
            self.logger.error(stopmsg)
            errprint('ERROR: ' + stopmsg)
            return False
        return True

    @classmethod
    def run(cls, config, logger):
        """Process the input directory. Returns the final summary's
        ``print_results`` when every read found was processed, else
        None."""
        with cls(config, logger) as sess:
            sess.show_message('==> Processing FAST5 files')
            sess.analyzer = BatchAnalyzer(config)
            chunk = config['batch_chunk_size']
            batch = []
            completed = True
            for entry in sess.entries():
                sess.reads_found += 1
                batch.append(entry)
                if len(batch) >= chunk:
                    completed = sess.process_batch(batch)
                    batch = []
                    if not completed:
                        break
            if batch and completed:
                completed = sess.process_batch(batch)
            GLOBAL_TIMER.report(logger)

            if completed and sess.reads_found == sess.reads_processed:
                sess.show_message('==> Finished.')
                return sess.finalsummary_tracker.print_results
            sess.show_message('==> Terminated.')
            return None
