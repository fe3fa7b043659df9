"""PHASE A over ingest worker processes (poreplex_torch/pipeline/ingest.py)
on the CPU, held against PHASE A in the analyzer's process and against
poreplex-tpu's session with its ingest workers:

- a worker's payloads equal the in-process ones over a DirectorySource
  (native reader first, h5py per read) and a MemorySource (sent to each
  worker once): pooled frames bit for bit, raw DAC, basecall, and every
  status of the lattice (disappeared, irregular_fast5,
  scaler_signal_too_short, a deferred basecall error, an unhandled
  exception's report); the records filed from them too;
- the workers import neither torch nor jax; each A:* stage of a pooled
  batch is at most the batch's wall time;
- a pool that raises is shut down and the batch is loaded in-process with
  the same records;
- an offline session with -p 2 (two workers) writes the same summary,
  FASTQ and manifest bytes as one with -p 1 (no worker) and as
  poreplex-tpu's session with ingest_processes=2;
- a session reads batch k+1 on a monitor thread while batch k computes,
  computes in scan order, and holds at most two batches' reads;
- each part of PHASE A is added once a batch, in the span log as a sum
  inside its A:fast5_load.

The spawned pools are made once a module (each takes a second or two)."""

import contextlib
import gzip
import logging
import os
import threading
import time
import types

import h5py
import numpy as np
import pytest

from poreplex_torch import simulate
from poreplex_torch.config import build_config
from poreplex_torch.pipeline import ingest
from poreplex_torch.pipeline.analyzer import BatchAnalyzer
from poreplex_torch.pipeline.source import MemorySource
from poreplex_torch.utils import GLOBAL_TIMER
from test_torch_session import output_files, reduce_shapes

LOGGER = logging.getLogger('test-torch-ingest')
# stage-1 rows a launch; the pooled batch of the payload tests is cut into
# two chunks (CHUNK_READS = 64)
DEVICE_BATCH = 8
REPEAT = 5


def no_timer(name):
    return contextlib.nullcontext()


def analyzer_config(indir, outdir, **options):
    config = build_config(str(indir), str(outdir), device='cpu',
                          device_batch_size=DEVICE_BATCH, barcoding=True,
                          trim_adapter=True, measure_polya=True, **options)
    reduce_shapes(config)
    return config


# ---------------------------------------------------------------- lattice

def directory_lattice(d):
    """FAST5 files that give every status of PHASE A: (entries, the
    status each entry must get; 'error' is an unhandled exception's
    report, 'bcall_error' an okay read whose basecall failed to read)."""
    entries = simulate.make_fixture_dir(str(d), n_reads=3, seed=5,
                                        multi_read=True, transcript_len=3000)
    entries += [(os.path.join('guppy', name), read_id) for name, read_id in
                simulate.make_fixture_dir(str(d / 'guppy'), n_reads=2,
                                          seed=6, basecall='guppy',
                                          transcript_len=3000)]
    rng = np.random.default_rng(7)
    reads = [simulate.simulate_read(rng, transcript_len=3000)
             for _ in range(4)]
    reads[1].raw_dac = reads[1].raw_dac[:300]
    for i, read in enumerate(reads):
        simulate.write_single_read_fast5(str(d / 'single{}.fast5'.format(i)),
                                         read)
    with h5py.File(str(d / 'single2.fast5'), 'r+') as f:
        del f['Analyses/Basecall_1D_000/BaseCalled_template/Fastq']
    with h5py.File(str(d / 'single3.fast5'), 'r+') as f:
        del f['Raw/Reads/Read_1001/Signal']
    (d / 'broken.fast5').write_bytes(b'not an HDF5 file')
    entries += [('single{}.fast5'.format(i), read.read_id)
                for i, read in enumerate(reads)]
    entries += [('broken.fast5', 'broken'), ('gone.fast5', 'gone'),
                ('single0.fast5', 'another-read')]
    statuses = ['okay'] * 6 + [
        'scaler_signal_too_short', 'bcall_error', 'error',
        'irregular_fast5', 'disappeared', 'irregular_fast5']
    return entries, statuses


def memory_lattice():
    rng = np.random.default_rng(8)
    reads = [simulate.simulate_read(rng, transcript_len=3000)
             for _ in range(4)]
    reads[1].raw_dac = reads[1].raw_dac[:300]
    reads[2].events = None
    reads[3].start_time = 'not a number'
    source = MemorySource(reads)
    entries = source.read_ids(None) + [
        ('gone.fast5', 'gone'), (MemorySource.FILENAME, 'another-read')]
    statuses = ['okay', 'scaler_signal_too_short', 'bcall_error', 'error',
                'disappeared', 'irregular_fast5']
    return source, entries, statuses


@pytest.fixture(scope='module')
def analyzers(tmp_path_factory):
    """{kind: (analyzer with two ingest workers, entries, statuses)} for a
    FAST5 directory and for reads in memory."""
    d = tmp_path_factory.mktemp('ingest-lattice')
    out = tmp_path_factory.mktemp('ingest-out')
    entries, statuses = directory_lattice(d)
    source, mem_entries, mem_statuses = memory_lattice()
    built = {
        'directory': (BatchAnalyzer(analyzer_config(
            d, out, ingest_processes=2)), entries, statuses),
        'memory': (BatchAnalyzer(analyzer_config(
            d, out, ingest_processes=2), source=source), mem_entries,
            mem_statuses),
    }
    yield built
    for analyzer, _, _ in built.values():
        analyzer.close()


def status_of(p):
    if 'error' in p:
        assert p['error']['status'] == 'unknown_error'
        return 'error'
    if 'bcall_error' in p:
        return 'bcall_error'
    return p['status']


def assert_same_payload(got, ref):
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        if key in ('pooled', 'raw_dac', 'raw_pa'):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value)
        elif key == 'bcall_error':
            assert type(got[key]) is type(value)
            assert got[key].args == value.args
        elif key == 'bcall' and value is not None:
            bcall = got[key]
            assert bcall.keys() == value.keys()
            for name in value:
                if name != 'events':
                    assert bcall[name] == value[name], name
            for col in ingest.EVENT_COLUMNS:
                assert bcall['events'][col].dtype == \
                    value['events'][col].dtype
                np.testing.assert_array_equal(bcall['events'][col],
                                              value['events'][col])
        else:
            assert got[key] == value, key


@pytest.mark.parametrize('kind', ['directory', 'memory'])
def test_worker_payloads_match_in_process(analyzers, kind):
    analyzer, entries, statuses = analyzers[kind]
    batch = entries * REPEAT
    pooled, _ = analyzer.ingest_pool.load(batch)
    ref = ingest.load_reads(batch, analyzer.source, analyzer.ingest_params,
                            no_timer)
    assert [status_of(p) for p in ref] == statuses * REPEAT
    assert len(pooled) == len(ref)
    for got, want in zip(pooled, ref):
        assert_same_payload(got, want)
    okay = [p for p in ref if 'pooled' in p]
    assert okay and all(p['raw_dac'].dtype == np.int16 for p in okay)


def test_worker_reads_albacore_natively(analyzers):
    """The native reader read the albacore reads (its event table also
    carries each event's k-mer, where h5py reads the columns asked for)
    and h5py the guppy ones (events rebuilt from the Move table)."""
    analyzer, entries, _ = analyzers['directory']
    pooled, _ = analyzer.ingest_pool.load(entries[:5])
    ref = ingest.load_reads(entries[:5], analyzer.source,
                            analyzer.ingest_params, no_timer)
    columns = [[set(p['bcall']['events']._cols) for p in payloads]
               for payloads in (pooled, ref)]
    native = set(ingest.EVENT_COLUMNS) | {'model_state'}
    assert columns[0][:3] == [native] * 3
    assert columns[1][:3] == [set(ingest.EVENT_COLUMNS)] * 3
    assert columns[0][3:] == columns[1][3:] and 'stdv' in columns[0][3]


@pytest.mark.parametrize('kind', ['directory', 'memory'])
def test_worker_records_match_in_process(analyzers, kind):
    analyzer, entries, statuses = analyzers[kind]
    results, records = analyzer.load_batch(entries)
    pool, analyzer.ingest_pool = analyzer.ingest_pool, None
    try:
        ref_results, ref_records = analyzer.load_batch(entries)
    finally:
        analyzer.ingest_pool = pool
    assert results == ref_results
    assert len(results) == statuses.count('scaler_signal_too_short') + \
        statuses.count('error') + statuses.count('irregular_fast5') + \
        statuses.count('disappeared')
    assert len(records) == len(ref_records) == \
        statuses.count('okay') + statuses.count('bcall_error')
    for rec, ref in zip(records, ref_records):
        assert rec.report() == ref.report()
        np.testing.assert_array_equal(rec.pooled, ref.pooled)
        np.testing.assert_array_equal(rec.raw_dac, ref.raw_dac)
        assert (rec.head_len, rec.calib) == (ref.head_len, ref.calib)
        assert (rec.bcall is None) == (ref.bcall is None)
        assert type(rec.bcall_error) is type(ref.bcall_error)


@pytest.mark.parametrize('kind', ['directory', 'memory'])
def test_workers_import_no_torch(analyzers, kind):
    analyzer, entries, _ = analyzers[kind]
    analyzer.ingest_pool.load(entries * REPEAT)
    pids = analyzer.ingest_pool.worker_pids()
    assert len(pids) == 2 and os.getpid() not in pids
    for pid, packages in analyzer.ingest_pool.warm():
        assert pid in pids
        assert 'numpy' in packages
        assert 'torch' not in packages and 'jax' not in packages


@pytest.mark.parametrize('kind', ['directory', 'memory'])
def test_stage_times_within_the_batch(analyzers, kind):
    """A stage's time is the largest of its chunks' sums, so it is at most
    the batch's wall time."""
    analyzer, entries, _ = analyzers[kind]
    t0 = time.perf_counter()
    _, timers = analyzer.ingest_pool.load(entries * REPEAT)
    wall = time.perf_counter() - t0
    assert set(timers) == set(ingest.STAGES)
    assert all(0 < timers[name] <= wall for name in ingest.STAGES)


def test_broken_pool_falls_back_in_process(analyzers):
    analyzer, entries, _ = analyzers['directory']
    shut = []

    class Dead:
        def load(self, reads):
            raise RuntimeError('the worker pool died')

        def shutdown(self):
            shut.append(True)
    pool, analyzer.ingest_pool = analyzer.ingest_pool, Dead()
    try:
        results, records = analyzer.load_batch(entries)
        assert analyzer.ingest_pool is None and shut == [True]
        ref_results, ref_records = analyzer.load_batch(entries)
    finally:
        analyzer.ingest_pool = pool
    assert results == ref_results
    assert [r.report() for r in records] == [r.report() for r in ref_records]
    for rec, ref in zip(records, ref_records):
        np.testing.assert_array_equal(rec.pooled, ref.pooled)


# ---------------------------------------------------------------- sessions

@pytest.fixture(scope='module')
def sessions(tmp_path_factory):
    """The outputs of one fixture run by a torch session with -p 2 and one
    with -p 1, and by poreplex-tpu's session with ingest_processes=2; the
    -p 2 session's workers as IngestPool.warm saw them; each torch
    session's stage timers and span log, by -p."""
    from poreplex_tpu.config import build_config as jax_build_config
    from poreplex_tpu.pipeline.session import \
        ProcessingSession as JaxSession
    from poreplex_torch.pipeline.session import ProcessingSession

    indir = tmp_path_factory.mktemp('ingest-session-in')
    simulate.make_fixture_dir(str(indir), n_reads=6, seed=20,
                              polya_len=2400)
    simulate.make_fixture_dir(str(indir / 'nested'), n_reads=3, seed=21,
                              multi_read=True, basecall='guppy')
    options = dict(device_batch_size=DEVICE_BATCH, barcoding=True,
                   trim_adapter=True, measure_polya=True,
                   filter_unsplit_reads=True, quiet=True)
    outputs, workers, timers = {}, {}, {}
    warm = ingest.IngestPool.warm
    for parallel in (2, 1):
        seen = workers[parallel] = []

        def recording_warm(pool):
            pings = warm(pool)
            seen.append((pool.worker_pids(), pings))
            return pings
        out = tmp_path_factory.mktemp('ingest-session-p{}'.format(parallel))
        config = build_config(str(indir), str(out), device='cpu',
                              parallel=parallel, **options)
        reduce_shapes(config)
        GLOBAL_TIMER.totals.clear()
        GLOBAL_TIMER.counts.clear()
        with pytest.MonkeyPatch.context() as mp, \
                GLOBAL_TIMER.recording() as log:
            mp.setattr(ingest.IngestPool, 'warm', recording_warm)
            assert ProcessingSession.run(config, LOGGER) is not None
        timers[parallel] = GLOBAL_TIMER.snapshot(), log
        outputs[parallel] = output_files(str(out))

    out = tmp_path_factory.mktemp('ingest-session-jax')
    jconfig = jax_build_config(str(indir), str(out), ingest_processes=2,
                               **options)
    reduce_shapes(jconfig)
    assert JaxSession.run(jconfig, LOGGER) is not None
    outputs['jax'] = output_files(str(out))
    return outputs, workers, timers


def written(files):
    """The summary, the manifest and the FASTQ records of a session."""
    fastq = {path: gzip.decompress(data) for path, data in files.items()
             if path.startswith('fastq' + os.sep)}
    return files['sequencing_summary.txt'], files['.processed-reads'], fastq


def test_session_with_workers_writes_what_in_process_writes(sessions):
    outputs, _, _ = sessions
    summary, manifest, fastq = written(outputs[2])
    assert len(summary.decode().splitlines()) == 10
    assert sum(len(data.splitlines()) // 4 for data in fastq.values()) == 9
    assert written(outputs[1]) == (summary, manifest, fastq)
    for path in outputs[1]:
        if path != 'poreplex.log':
            assert outputs[2][path] == outputs[1][path], path


def test_session_with_workers_writes_what_jax_writes(sessions):
    outputs, _, _ = sessions
    assert written(outputs[2]) == written(outputs['jax'])
    assert set(outputs[2]) == set(outputs['jax'])


def test_parallel_two_starts_two_workers_without_torch(sessions):
    _, workers, _ = sessions
    assert workers[1] == []         # -p 1: PHASE A in the analyzer's process
    ((pids, pings),) = workers[2]
    assert len(pids) == 2 and os.getpid() not in pids
    for pid, packages in pings:
        assert pid in pids
        assert 'torch' not in packages and 'jax' not in packages


@pytest.mark.parametrize('parallel', [2, 1])
def test_session_ingest_parts_within_fast5_load(sessions, parallel):
    """Each part of PHASE A is added once a batch, over workers and in
    process alike."""
    _, _, timers = sessions
    stages, _ = timers[parallel]
    load = stages['A:fast5_load']
    assert load['calls'] == 1
    for name in ingest.STAGES:
        assert stages[name]['calls'] == load['calls']
        assert stages[name]['total_s'] <= load['total_s'], name


@pytest.mark.parametrize('parallel', [2, 1])
def test_session_span_log(sessions, parallel):
    """A session's span log: PHASE A's parts are sums inside its
    A:fast5_load, the batch's compute one S:analyze_batch holding the
    analyzer's phases, and the poly(A) windows counted by bucket, all
    with the batch's id."""
    _, _, timers = sessions
    stages, log = timers[parallel]
    by_name = {}
    for span in log.spans:
        by_name.setdefault(span.name, []).append(span)
    (load,) = by_name['A:fast5_load']
    (compute,) = by_name['S:analyze_batch']
    assert load.batch == compute.batch == 0
    assert load.thread != compute.thread
    for name in ingest.STAGES:
        (part,) = by_name[name]
        assert (part.kind, part.parent, part.batch) == ('sum', load.id, 0)
    (stage1,) = by_name['B:device_stage1']
    assert (stage1.parent, stage1.thread) == (compute.id, compute.thread)
    windows = [c for c in log.counts if c[0].startswith('C:polya/windows@')]
    assert windows and all(c[5] == 0 and c[3] == compute.thread
                           for c in windows)
    assert sum(c[1] for c in windows) == sum(
        row['count'] for name, row in stages.items()
        if name.startswith('C:polya/windows@'))
    assert sum(c[1] for c in windows) >= stages['C:polya/launch']['calls']
    assert not [s for s in log.spans if s.name.startswith('W:')]


def test_phase_a_overlaps_the_batch_before(tmp_path, monkeypatch):
    """With a batch a read, each batch's PHASE A (on a monitor thread)
    starts while the batch before computes (on the compute thread) and
    not before the batch two before has computed; batches compute, and
    their reads are recorded done, in scan order."""
    from poreplex_torch.pipeline.session import ProcessingSession
    lock = threading.Lock()
    events = []

    def record(what, files):
        with lock:
            events.append((what, files[0][1], threading.get_ident(),
                           time.monotonic()))

    def fake_load(self, files):
        record('load', files)
        time.sleep(0.02)
        return files

    def fake_analyze(self, files):
        record('compute', files)
        time.sleep(0.15)
        record('computed', files)
        return [{'filename': name, 'read_id': read_id, 'status': 'okay'}
                for name, read_id in files], {}
    monkeypatch.setattr(ProcessingSession, 'load_batch', fake_load)
    monkeypatch.setattr(ProcessingSession, 'analyze_batch', fake_analyze)
    ids = ['read-{}'.format(i) for i in range(5)]
    config = build_config(str(tmp_path), str(tmp_path), device='cpu',
                          batch_chunk_size=1, quiet=True)
    source = MemorySource([types.SimpleNamespace(read_id=i) for i in ids])
    assert ProcessingSession.run(config, LOGGER, source) is not None

    def at(what, read_id):
        (event,) = [e for e in events if e[:2] == (what, read_id)]
        return event
    assert [e[1] for e in events if e[0] == 'compute'] == ids
    compute_threads = {e[2] for e in events if e[0] != 'load'}
    assert len(compute_threads) == 1
    assert not compute_threads & {e[2] for e in events if e[0] == 'load'}
    for k in range(1, len(ids)):
        assert at('load', ids[k])[3] < at('computed', ids[k - 1])[3]
        if k >= 2:
            assert at('load', ids[k])[3] >= at('computed', ids[k - 2])[3]
    with open(tmp_path / '.processed-reads') as f:
        assert [line.split('\t')[1] for line in f.read().splitlines()] == ids
