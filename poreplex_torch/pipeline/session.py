"""Processing session: an asyncio loop that scans the read source (and, in
live mode, watches it for new files), gathers its entries into batches of
``batch_chunk_size``, runs each batch through the BatchAnalyzer and writes
the results to every enabled sink.

A batch's PHASE A (reading its reads: pipeline/ingest.py, over worker
processes with ``-p``) runs on a monitor thread while the batch before it
computes; the device phases run on one compute thread, one batch at a
time and in scan order, and a batch's writes run on one writer thread
while the next batch computes, so the written order is the scan order
too; with ``--align`` the writer thread also maps the batch's basecalls
into BAM files (alignment.py), and their tallies feed the dashboard
(dashboard.py), which draws on the loop. A batch starts loading once the
batch two before it has computed, so at most two batches' reads are held
at once. Every read that
finishes ``okay`` is appended to ``OUTDIR/.processed-reads``; with
``resume`` the reads listed there are skipped, and in live mode a read
found again is not queued twice. The reads come from the input
directory's FAST5 files unless the caller hands ``run`` another source
(pipeline/source.py). In a process group of several
ranks (parallel/distributed.py, joined by the caller before the session
starts) a session queues only the entries its rank owns, and the final
counts are summed over the ranks at the end; rank 0 prints them.
"""

import asyncio
import os
import sys
import threading
import time
import traceback
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from io import StringIO
from itertools import cycle

from ..io.writers import (
    FASTQWriter, FAST5Writer, SequencingSummaryWriter,
    NanopolishReadDBWriter, FinalSummaryTracker, DumpWriter,
    create_adapter_dumps_inventory, create_events_inventory)
from ..parallel import distributed
from ..utils import errprint, GLOBAL_TIMER
from .analyzer import BatchAnalyzer
from .source import DirectorySource

# sinks that copy input FAST5 files or write HDF5 dumps
FILE_SINKS = ('fast5_output', 'nanopolish_output', 'dump_adapter_signals',
              'dump_basecalls')


class ComputeIdle:
    """The compute thread's idle time between two batches, as two spans
    that tile it: ``W:compute_waits_load`` from the end of batch N-1's
    ``S:analyze_batch`` to the end of batch N's PHASE A, where PHASE A
    ends later, added when PHASE A ends; ``W:compute_handoff`` from the
    later of the two to the start of batch N's ``S:analyze_batch`` (the
    event loop's hand-off), added when it starts. The first batch has
    neither. Batch ids are consecutive in compute order."""

    def __init__(self):
        self.lock = threading.Lock()
        self.loaded = {}        # batch id: perf_counter when PHASE A ended
        self.computed = {}      # batch id: perf_counter when compute ended

    def phase_a_ended(self, batchid):
        with self.lock:
            now = time.perf_counter()
            self.loaded[batchid] = now
            before = self.computed.get(batchid - 1)
        if before is not None:
            GLOBAL_TIMER.add('W:compute_waits_load', now - before)

    def compute_starts(self, batchid):
        now = time.perf_counter()
        with self.lock:
            loaded = self.loaded.pop(batchid, None)
            before = self.computed.pop(batchid - 1, None)
        if loaded is not None and before is not None:
            GLOBAL_TIMER.add('W:compute_handoff', now - max(loaded, before))

    def compute_ended(self, batchid):
        with self.lock:
            self.computed[batchid] = time.perf_counter()


class ProcessingSession:

    # live mode: seconds between two polls of the input when inotify is
    # missing, and the shortest heartbeat of the stalled-queue watchdog
    POLL_INTERVAL = 2.0
    MIN_HEARTBEAT = 10

    def __init__(self, config, logger, source=None):
        self.running = True
        self.scan_finished = False
        self.reads_queued = self.reads_found = 0
        self.reads_processed = 0
        self.next_batch_id = 0
        self.reads_done = set()
        self.active_batches = 0
        self.error_status_counts = defaultdict(int)
        self.jobstack = []
        self.tasks = set()

        self.config = config
        self.logger = logger
        self.dist_rank, self.dist_size = distributed.process_info()
        if self.dist_size > 1:
            logger.info('Distributed session: rank %d of %d',
                        self.dist_rank, self.dist_size)
        self.source = source if source is not None else \
            DirectorySource(config['inputdir'])
        refused = [key for key in FILE_SINKS if config[key]]
        if refused and not self.source.holds_files:
            raise ValueError(
                '{} need FAST5 input files and h5py; a {} has neither'.format(
                    ', '.join(refused), type(self.source).__name__))
        self.analyzer = None
        self.analyzer_lock = threading.Lock()
        # the futures of the two batches submitted last, each done once
        # that batch has computed (or ended without computing)
        self.computed = (None, None)
        self.idle = ComputeIdle()

        self.executor_compute = ThreadPoolExecutor(1)
        self.executor_io = ThreadPoolExecutor(1)
        # PHASE A, the source's listing and the live watcher
        self.executor_mon = ThreadPoolExecutor(max(2, config['parallel']))

        self.loop = None
        self.fastq_writer = self.fast5_writer = None
        self.npreaddb_writer = self.seqsummary_writer = None
        self.dump_writer = None
        self.alignment_writer = None
        self.finalsummary_tracker = None
        self.dashboard = None

        self.manifest_path = os.path.join(config['outputdir'],
                                          '.processed-reads')
        self.manifest_file = None
        if config['resume']:
            self._load_manifest()

    # ------------------------------------------------------------------
    def __enter__(self):
        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)

        import signal as signal_mod
        for signame in ('SIGINT', 'SIGTERM'):
            try:
                self.loop.add_signal_handler(
                    getattr(signal_mod, signame), self.stop, signame)
            except (NotImplementedError, RuntimeError):
                pass

        config = self.config
        if config['fastq_output']:
            self.fastq_writer = FASTQWriter(config['outputdir'],
                                            config['output_layout'])
        if config['fast5_output']:
            self.fast5_writer = FAST5Writer(
                config['outputdir'], config['output_layout'],
                config['inputdir'], config['fast5_batch_size'])
        if config['nanopolish_output']:
            self.npreaddb_writer = NanopolishReadDBWriter(
                config['outputdir'], config['output_layout'])
        self.seqsummary_writer = SequencingSummaryWriter(
            config, config['outputdir'], config['label_names'],
            config['barcode_names'])
        self.finalsummary_tracker = FinalSummaryTracker(
            config['label_names'], config['barcode_names'])
        if config['dump_adapter_signals'] or config['dump_basecalls']:
            self.dump_writer = DumpWriter(config)
        if config['minimap2_index']:
            self.show_message('==> Loading a minimap2 index file')
            from ..alignment import AlignmentWriter
            self.alignment_writer = AlignmentWriter(
                config['minimap2_index'],
                os.path.join(config['outputdir'], 'bam', '{}.bam'),
                config['output_layout'])
        return self

    def __exit__(self, *args):
        # a batch cancelled while its thread still runs finishes first
        self.executor_mon.shutdown()
        self.executor_compute.shutdown()
        self.executor_io.shutdown()
        if self.analyzer is not None:
            self.analyzer.close()
        for writer in (self.fastq_writer, self.fast5_writer,
                       self.npreaddb_writer, self.seqsummary_writer,
                       self.alignment_writer, self.dump_writer):
            if writer is not None:
                writer.close()
        self.fastq_writer = self.fast5_writer = None
        self.npreaddb_writer = self.seqsummary_writer = None
        self.alignment_writer = self.dump_writer = None
        if self.manifest_file is not None:
            self.manifest_file.close()
            self.manifest_file = None
        self.loop.close()

    # ------------------------------------------------------------------
    def _load_manifest(self):
        if not os.path.exists(self.manifest_path):
            return
        with open(self.manifest_path) as f:
            for line in f:
                parts = line.rstrip('\n').split('\t')
                if len(parts) == 2:
                    self.reads_done.add((parts[0], parts[1]))
        if self.reads_done:
            self.show_message('==> Resuming: {} reads already processed'
                              .format(len(self.reads_done)))

    def _record_processed(self, readpaths):
        if self.manifest_file is None:
            self.manifest_file = open(self.manifest_path, 'a')
        for filename, read_id in readpaths:
            self.manifest_file.write('{}\t{}\n'.format(filename, read_id))
        self.manifest_file.flush()

    # ------------------------------------------------------------------
    def errx(self, message):
        if self.running:
            errprint(message)
            self.stop('ERROR')

    def show_message(self, message):
        if not self.config['quiet']:
            print(message)

    def stop(self, signalname='unknown'):
        if self.running:
            if signalname in ('SIGTERM', 'SIGINT'):
                errprint('\nTermination in process. Please wait for a moment.')
            self.running = False
        for task in asyncio.all_tasks(self.loop):
            task.cancel()

    def run_in_executor_mon(self, *args):
        return self.loop.run_in_executor(self.executor_mon, *args)

    def spawn(self, coro):
        """A task on the session's loop, held until it is done (the loop
        holds its tasks weakly)."""
        task = self.loop.create_task(coro)
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)
        return task

    # ------------------------------------------------------------------
    def get_analyzer(self):
        """The session's BatchAnalyzer, built by the thread that first
        needs it (timed as ``S:build_analyzer``)."""
        with self.analyzer_lock:
            if self.analyzer is None:
                with GLOBAL_TIMER.stage('S:build_analyzer'):
                    self.analyzer = BatchAnalyzer(self.config, self.source)
            return self.analyzer

    def load_batch(self, files):
        """On a monitor thread: PHASE A of one batch."""
        return self.get_analyzer().load_batch(files)

    def analyze_batch(self, preloaded):
        """On the compute thread: the rest of a batch loaded by
        load_batch; returns (results, aux)."""
        return self.get_analyzer().process_batch(None, preloaded)

    def _phase_a(self, batchid, files):
        """On a monitor thread: load_batch with the batch's id on the
        thread's spans."""
        with GLOBAL_TIMER.batch(batchid):
            preloaded = self.load_batch(files)
            self.idle.phase_a_ended(batchid)
        return preloaded

    def _compute(self, batchid, preloaded):
        """On the compute thread: analyze_batch, timed as
        ``S:analyze_batch`` (and its thread CPU as ``S:analyze_batch/cpu_ns``)
        with the batch's id on the thread's spans."""
        with GLOBAL_TIMER.batch(batchid):
            self.idle.compute_starts(batchid)
            with GLOBAL_TIMER.stage('S:analyze_batch', cpu=True):
                computed = self.analyze_batch(preloaded)
            self.idle.compute_ended(batchid)
        return computed

    def write_results(self, batchid, results, aux):
        """On the writer thread: every enabled sink, each timed as
        ``D:io_<sink method>``. Returns the alignment writer's tallies, or
        None without one."""
        def timed(fn, *args):
            with GLOBAL_TIMER.stage('D:io_' + fn.__qualname__):
                return fn(*args)

        with GLOBAL_TIMER.batch(batchid):
            if self.fastq_writer is not None:
                timed(self.fastq_writer.write_sequences, results)
            if self.fast5_writer is not None:
                timed(self.fast5_writer.transfer_reads, results)
            if self.npreaddb_writer is not None:
                timed(self.npreaddb_writer.write_sequences, results)
            rescounts = None
            if self.alignment_writer is not None:
                rescounts = timed(self.alignment_writer.process, results)
            if self.dump_writer is not None:
                timed(self.dump_writer.write_aux, batchid, aux)
            timed(self.seqsummary_writer.write_results, results)
        return rescounts

    async def run_process_batch(self, batchid, files):
        # taken before the first await, so in the order of submission
        before_last, last = self.computed
        computed = self.loop.create_future()
        self.computed = (last, computed)
        try:
            await self._process_batch(batchid, files, before_last, last,
                                      computed)
        finally:
            if not computed.done():
                computed.set_result(None)

    async def _process_batch(self, batchid, files, before_last, last,
                             computed):
        """PHASE A once the batch two before has computed, the device
        phases once the one before has, then the writes."""
        if self.config['analysis_start_delay'] > 0:
            try:
                await asyncio.sleep(self.config['analysis_start_delay'])
            except asyncio.CancelledError:
                return

        self.active_batches += 1
        try:
            if before_last is not None:
                await asyncio.shield(before_last)
            preloaded = await self.run_in_executor_mon(self._phase_a,
                                                       batchid, files)
            if last is not None:
                await asyncio.shield(last)
            results, aux = await self.loop.run_in_executor(
                self.executor_compute, self._compute, batchid, preloaded)
            computed.set_result(None)

            # a read already done (a live-mode re-feed) is dropped here
            nd_results = []
            newly_done = []
            for result in results:
                readpath = result['filename'], result['read_id']
                if readpath not in self.reads_done:
                    if result['status'] == 'okay':
                        self.reads_done.add(readpath)
                        newly_done.append(readpath)
                    elif 'error_message' in result:
                        self.logger.error(result['error_message'])
                    nd_results.append(result)
                else:
                    self.reads_queued -= 1
                    self.reads_found -= 1
                self.error_status_counts[result['status']] += 1
            if newly_done:
                self._record_processed(newly_done)

            if nd_results:
                rescounts = await self.loop.run_in_executor(
                    self.executor_io, self.write_results, batchid,
                    nd_results, aux)
                if self.dashboard is not None and rescounts is not None:
                    self.dashboard.feed_mapped(rescounts)
                self.finalsummary_tracker.feed_results(nd_results)

            # a stream of reads without basecalls: stop early
            if (self.error_status_counts['okay'] == 0 and self.running and
                    self.error_status_counts['not_basecalled'] >=
                    self.config['nobasecall_stop_trigger']):
                stopmsg = (
                    'Early stopping: {} out of {} reads are not basecalled. '
                    'Please check if the files are correctly analyzed, or '
                    'add `--basecall\' to the command line.'.format(
                        self.error_status_counts['not_basecalled'],
                        sum(self.error_status_counts.values())))
                self.logger.error(stopmsg)
                self.errx(stopmsg)

        except asyncio.CancelledError:
            return
        except Exception as exc:
            self.logger.error('Unhandled error during processing reads',
                              exc_info=exc)
            return self.errx('ERROR: Unhandled error ' + str(exc))
        finally:
            self.active_batches -= 1

        self.reads_processed += len(nd_results)
        self.reads_queued -= len(nd_results)

    # ------------------------------------------------------------------
    def queue_processing(self, readpath):
        """Admit one (filename, read_id) entry into the pending batch, if
        this rank owns it; a full pending batch is submitted at once."""
        if not distributed.owns_entry(readpath, self.dist_rank,
                                      self.dist_size):
            return
        self.reads_found += 1
        self.reads_queued += 1
        self.jobstack.append(readpath)
        if len(self.jobstack) >= self.config['batch_chunk_size']:
            self.flush_jobstack()

    def flush_jobstack(self):
        """Submit whatever is pending as one batch task. Entries done since
        they were queued (live-mode re-feeds) are dropped here, with the
        found and queued counts rolled back."""
        if not (self.running and self.jobstack):
            return
        pending, self.jobstack = self.jobstack, []
        fresh = [entry for entry in pending if entry not in self.reads_done]
        already_done = len(pending) - len(fresh)
        if already_done:
            self.reads_queued -= already_done
            self.reads_found -= already_done
        if fresh:
            batch_id = self.next_batch_id
            self.next_batch_id += 1
            self.spawn(self.run_process_batch(batch_id, fresh))

    async def scan_inputs(self):
        """Queue every entry of the source in scan order: a directory's
        files before its subdirectories. A file that cannot be listed is
        logged and skipped."""
        try:
            files = await self.run_in_executor_mon(self.source.list_files)
        except asyncio.CancelledError:
            return
        except Exception as exc:
            return self.errx('ERROR: ' + str(exc))

        for relpath in files:
            try:
                entries = await self.run_in_executor_mon(
                    self.source.read_ids, relpath)
            except asyncio.CancelledError:
                return
            except Exception as exc:
                self.logger.error('Could not list reads in %s: %s',
                                  relpath, exc)
                continue
            for readpath in entries:
                self.queue_processing(readpath)

        self.flush_jobstack()
        self.scan_finished = True

    # ------------------------------------------------------------------
    def _queue_file(self, relpath):
        for readpath in self.source.read_ids(relpath):
            if readpath not in self.reads_done:
                self.queue_processing(readpath)

    async def live_watch_inputs(self):
        """Queue the reads of files that appear in the source: through
        inotify where it can be imported and the source is a directory,
        else by polling the files' modification times."""
        have_inotify = False
        if isinstance(self.source, DirectorySource):
            try:
                from inotify.adapters import InotifyTree
                from inotify.constants import IN_CLOSE_WRITE, IN_MOVED_TO
                have_inotify = True
            except ImportError:
                pass

        try:
            if have_inotify:
                topdir = os.path.abspath(self.source.topdir) + '/'
                watch_flags = IN_CLOSE_WRITE | IN_MOVED_TO
                evgen = InotifyTree(topdir, mask=watch_flags).event_gen()
                while True:
                    event = await self.run_in_executor_mon(next, evgen)
                    if event is None:
                        continue
                    header, type_names, path, filename = event
                    if 'IN_ISDIR' in type_names:
                        continue
                    if (header.mask & watch_flags and filename[:1] != '.' and
                            filename.lower().endswith('.fast5')):
                        common = os.path.commonprefix([topdir, path])
                        if common != topdir:
                            errprint('ERROR: Change of {} detected, which is '
                                     'outside {}.'.format(path, topdir))
                            continue
                        self._queue_file(
                            os.path.join(path[len(common):], filename))
            else:
                seen = {}
                while self.running:
                    await asyncio.sleep(self.POLL_INTERVAL)
                    snapshot = await self.run_in_executor_mon(
                        self.source.snapshot)
                    for relpath, mtime in snapshot.items():
                        if seen.get(relpath) == mtime:
                            continue
                        seen[relpath] = mtime
                        try:
                            self._queue_file(relpath)
                        except Exception:
                            pass
        except asyncio.CancelledError:
            pass

    # ------------------------------------------------------------------
    async def wait_until_finish(self):
        while self.running:
            try:
                await asyncio.sleep(0.2)
            except asyncio.CancelledError:
                break
            if self.scan_finished and self.reads_queued <= 0 and \
                    self.active_batches <= 0:
                break

    async def wait_for_stop(self):
        while self.running:
            try:
                await asyncio.sleep(0.5)
            except asyncio.CancelledError:
                break

    async def force_flushing_stalled_queue(self):
        """Live-mode watchdog: when no new read has been found for two
        heartbeats in a row while entries wait below the batch size,
        submit them anyway, so a paused sequencer does not strand a
        partial batch."""
        heartbeat = max(self.MIN_HEARTBEAT,
                        int(self.config['analysis_start_delay']) // 2)
        last_found = -1
        quiet_beats = 0
        while self.running:
            try:
                await asyncio.sleep(heartbeat)
            except asyncio.CancelledError:
                break
            if self.reads_found != last_found:
                last_found = self.reads_found
                quiet_beats = 0
            elif self.reads_queued > 0:
                quiet_beats += 1
                if quiet_beats >= 2:
                    quiet_beats = 0
                    self.flush_jobstack()

    async def _show_progress(self, format_line):
        spinner = cycle(r'/-\|')
        prev_width = 0
        while self.running:
            msg = format_line(next(spinner))
            if len(msg) < prev_width:
                msg += ' ' * (prev_width - len(msg))
            prev_width = len(msg)
            sys.stdout.write(msg)
            sys.stdout.flush()
            try:
                await asyncio.sleep(0.3)
            except asyncio.CancelledError:
                break

    async def show_progresses_offline(self):
        await self._show_progress(
            lambda spin: '\r[{}] {} processed / {} found{}'.format(
                spin, self.reads_processed, self.reads_found,
                '' if self.scan_finished else ' (scanning)'))

    async def show_progresses_live(self):
        self.show_message('==> Entering LIVE mode.')
        self.show_message('\nPress Ctrl-C when the sequencing run is '
                          'finished.')
        self.show_message('(!) An analysis starts at least {} seconds after '
                          'the file is discovered.'.format(
                              self.config['analysis_start_delay']))
        await self._show_progress(
            lambda spin: '\rLIVE [{}] {} processed, {} queued ({} total '
                         'reads)'.format(spin, self.reads_processed,
                                         self.reads_queued, self.reads_found))

    def start_dashboard(self):
        """The dashboard on the session's loop; contig aliases are read
        when alignment is on."""
        from .. import dashboard
        if self.config['contig_aliases'] and self.config['minimap2_index']:
            aliases = dashboard.load_aliases(self.config['contig_aliases'])
        else:
            aliases = {}
        view = dashboard.DashboardView(
            self, self.config['barcode_names'], 'progress', 'mapped_rate',
            self.config['analysis_start_delay'], aliases)
        view.start(self.loop, bool(self.config['minimap2_index']))
        return view

    def finalize_results(self):
        # the dump part files are closed before the inventories link into
        # them
        if self.dump_writer is not None:
            self.dump_writer.close()
        if self.config['dump_adapter_signals']:
            self.show_message(
                '==> Creating an inventory for adapter signal dumps')
            prefix = os.path.join(self.config['outputdir'], 'adapter-dumps')
            create_adapter_dumps_inventory(
                os.path.join(prefix, 'inventory.h5'),
                os.path.join(prefix, 'part-*.h5'))
        if self.config['dump_basecalls']:
            self.show_message(
                '==> Creating an inventory for basecalled events')
            prefix = os.path.join(self.config['outputdir'], 'events')
            create_events_inventory(
                os.path.join(prefix, 'inventory.h5'),
                os.path.join(prefix, 'part-*.h5'))

    # ------------------------------------------------------------------
    @classmethod
    def run(cls, config, logger, source=None):
        """Process every read of ``source`` (the input directory's FAST5
        files by default). Returns the final summary's ``print_results``
        when every read found was processed, else None; with several
        ranks, rank 0 returns the merged summary's and the others None."""
        with cls(config, logger, source) as sess:
            sess.show_message('==> Processing FAST5 files')
            loop = sess.loop

            if config['live']:
                sess.spawn(sess.force_flushing_stalled_queue())
                finish_task = sess.spawn(sess.wait_for_stop())
            else:
                finish_task = sess.spawn(sess.wait_until_finish())

            if config['quiet']:
                pass
            elif config['dashboard']:
                sess.dashboard = sess.start_dashboard()
            elif config['live']:
                sess.spawn(sess.show_progresses_live())
            else:
                sess.spawn(sess.show_progresses_offline())

            sess.spawn(sess.scan_inputs())
            if config['live']:
                sess.spawn(sess.live_watch_inputs())

            try:
                loop.run_until_complete(finish_task)
            except asyncio.CancelledError:
                errprint('\nInterrupted')
            except Exception as exc:
                errf = StringIO()
                traceback.print_exc(file=errf)
                errprint('\nERROR: ' + str(exc))
                for line in errf.getvalue().splitlines():
                    logger.error(line)

            if sess.dashboard is not None:
                sess.dashboard.stop()

            for task in [t for t in asyncio.all_tasks(loop) if not t.done()]:
                task.cancel()
                try:
                    loop.run_until_complete(task)
                except asyncio.CancelledError:
                    pass
                except Exception as exc:
                    errprint('\nERROR: ' + str(exc))

            if not config['quiet'] and sess.scan_finished:
                sess.show_message('')
            GLOBAL_TIMER.report(logger)

            if sess.scan_finished and \
                    sess.reads_found == sess.reads_processed:
                sess.finalize_results()
                if sess.dist_size > 1:
                    # a collective: every rank comes here once it has
                    # processed its reads
                    logger.info('Merging final counts across %d ranks',
                                sess.dist_size)
                    sess.finalsummary_tracker.counts = defaultdict(
                        int, distributed.merge_final_counts(
                            sess.finalsummary_tracker))
                    if sess.dist_rank != 0:
                        sess.show_message('==> Finished (host {}).'.format(
                            sess.dist_rank))
                        return None
                sess.show_message('==> Finished.')
                return sess.finalsummary_tracker.print_results
            if sess.scan_finished:
                sess.show_message('==> Terminated.')
            return None
