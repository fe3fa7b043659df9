"""The session options of the port, against poreplex-tpu's session where it
has the behaviour: a resumed run over an already-processed input processes
no read, keeps the manifest byte for byte as poreplex-tpu's and, as there,
leaves a header-only summary and empty FASTQ streams; the live watcher's
polling finds files that appear after it starts and skips the reads the
manifest holds, and so does its inotify branch; the stalled-queue
watchdog submits a partial batch after two quiet heartbeats, and
analysis_start_delay holds a batch back; a session over the memory
source writes what a session over FAST5 files of the same reads writes,
and refuses the sinks that need FAST5 files; and a stream of reads
without basecalls stops the session with poreplex-tpu's message."""

import asyncio
import gzip
import logging
import os
import re
import time
import types

import numpy as np
import pytest

from test_torch_session import output_files, reduce_shapes

LOGGER = logging.getLogger('test-session-options')


def packages():
    from poreplex_tpu.config import build_config as jax_build_config
    from poreplex_tpu.pipeline.session import \
        ProcessingSession as JaxSession
    from poreplex_torch.config import build_config
    from poreplex_torch.pipeline.session import ProcessingSession
    return {
        'jax': (lambda *a, **kw: jax_build_config(*a, **kw), JaxSession),
        'torch': (lambda *a, **kw: build_config(*a, device='cpu', **kw),
                  ProcessingSession),
    }


def session_config(package, indir, outdir, **options):
    build, _ = packages()[package]
    options.setdefault('device_batch_size', 8)
    options.setdefault('quiet', True)
    config = build(str(indir), str(outdir), **options)
    reduce_shapes(config)
    return config


# ------------------------------------------------------------------ resume

@pytest.fixture(scope='module')
def resumed_runs(tmp_path_factory):
    """Both packages over one input, then again with resume over the same
    output directory: {package: (files after the first run, files after
    the resumed run, the resumed run's result)}."""
    from poreplex_tpu import simulate
    indir = tmp_path_factory.mktemp('resume-in')
    simulate.make_fixture_dir(str(indir), n_reads=3, seed=20, polya_len=2400)
    runs = {}
    for package, (_, session) in packages().items():
        outdir = tmp_path_factory.mktemp('resume-' + package)
        first = session.run(session_config(package, indir, outdir),
                            LOGGER)
        assert first is not None
        before = output_files(str(outdir))
        with pytest.MonkeyPatch.context() as mp:
            if package == 'torch':
                # the resumed run builds no analyzer: no batch reaches it
                mp.setattr('poreplex_torch.pipeline.session.BatchAnalyzer',
                           None)
            result = session.run(session_config(package, indir, outdir,
                                                resume=True), LOGGER)
        runs[package] = before, output_files(str(outdir)), result
    return runs


def test_manifest_written_and_kept_on_resume(resumed_runs):
    jbefore, jafter, _ = resumed_runs['jax']
    before, after, _ = resumed_runs['torch']
    manifest = before['.processed-reads']
    assert len(manifest.decode().splitlines()) == 3
    assert manifest == jbefore['.processed-reads']
    assert after['.processed-reads'] == manifest
    assert jafter['.processed-reads'] == manifest


def test_resume_truncates_summary_and_fastq_as_jax(resumed_runs):
    """poreplex-tpu's writers open the summary and the FASTQ streams anew,
    so a resumed run keeps no earlier read in them; the port does the
    same (ROADMAP Queue 3)."""
    for package in ('jax', 'torch'):
        before, after, result = resumed_runs[package]
        assert result is not None, package
        assert len(before['sequencing_summary.txt'].splitlines()) == 4
        summary = after['sequencing_summary.txt'].decode().splitlines()
        assert summary == [before['sequencing_summary.txt'].decode()
                           .splitlines()[0]], package
        fastq = [p for p in after if p.startswith('fastq')]
        assert fastq, package
        for path in fastq:
            assert gzip.decompress(after[path]) == b'', (package, path)
    assert set(resumed_runs['torch'][1]) == set(resumed_runs['jax'][1])
    for path in resumed_runs['torch'][1]:
        assert resumed_runs['torch'][1][path] == \
            resumed_runs['jax'][1][path], path


# ------------------------------------------------------------------- live

@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_live_polling_finds_new_files(package, tmp_path, monkeypatch):
    """Files made after the watch starts are found; the read the resumed
    manifest holds is not queued again."""
    from poreplex_tpu import simulate
    staged = tmp_path / 'staged'
    entries = simulate.make_fixture_dir(str(staged), n_reads=2, seed=5)
    inputdir, outputdir = tmp_path / 'live-in', tmp_path / 'live-out'
    inputdir.mkdir()
    outputdir.mkdir()
    (outputdir / '.processed-reads').write_text('{}\t{}\n'.format(
        *entries[0]))
    _, session = packages()[package]
    if package == 'torch':
        monkeypatch.setattr(session, 'POLL_INTERVAL', 0.1)
    config = session_config(package, inputdir, outputdir, live=True,
                            resume=True, batch_chunk_size=1000)

    with session(config, LOGGER) as sess:
        assert sess.reads_done == {entries[0]}

        async def scenario():
            watch = sess.loop.create_task(
                sess.live_watch_inputs(str(inputdir)) if package == 'jax'
                else sess.live_watch_inputs())
            await asyncio.sleep(0.3)     # the watcher polls an empty input
            for name, _ in entries:
                os.link(str(staged / name), str(inputdir / name))
            deadline = time.time() + 20
            while time.time() < deadline and not sess.jobstack:
                await asyncio.sleep(0.05)
            watch.cancel()
            try:
                await watch
            except asyncio.CancelledError:
                pass
        sess.loop.run_until_complete(scenario())
        assert sess.jobstack == [entries[1]]
        assert sess.reads_found == 1


def fake_inotify(monkeypatch, topdir, events):
    """An inotify package whose InotifyTree yields ``events``, then idles;
    returns the list of trees made."""
    import sys
    created = []

    class FakeInotifyTree:
        def __init__(self, path, mask=0):
            self.path, self.mask = path, mask
            created.append(self)

        def event_gen(self):
            yield from events
            while True:
                time.sleep(0.05)
                yield None
    package = types.ModuleType('inotify')
    adapters = types.ModuleType('inotify.adapters')
    adapters.InotifyTree = FakeInotifyTree
    constants = types.ModuleType('inotify.constants')
    constants.IN_CLOSE_WRITE, constants.IN_MOVED_TO = 0x8, 0x80
    package.adapters, package.constants = adapters, constants
    for name, module in (('inotify', package), ('inotify.adapters', adapters),
                         ('inotify.constants', constants)):
        monkeypatch.setitem(sys.modules, name, module)
    return created


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_live_inotify_finds_new_files(package, tmp_path, monkeypatch):
    """The watcher's inotify branch, on a fake inotify: directory events,
    paths outside the input and other files are skipped; the FAST5 files
    closed or moved in are queued, but for the read already done."""
    from poreplex_tpu import simulate
    inputdir, outputdir = tmp_path / 'live-in', tmp_path / 'live-out'
    outputdir.mkdir()
    entries = simulate.make_fixture_dir(str(inputdir), n_reads=2, seed=6)
    topdir = os.path.abspath(str(inputdir)) + '/'
    hdr = types.SimpleNamespace
    created = fake_inotify(monkeypatch, topdir, [
        None,
        (hdr(mask=0x8), ['IN_ISDIR'], topdir, 'subdir'),
        (hdr(mask=0x8), [], '/elsewhere', 'evil.fast5'),
        (hdr(mask=0x8), [], topdir, 'notes.txt'),
        (hdr(mask=0x8), [], topdir, entries[0][0]),
        (hdr(mask=0x80), [], topdir, entries[1][0])])
    _, session = packages()[package]
    config = session_config(package, inputdir, outputdir, live=True,
                            batch_chunk_size=1000)

    with session(config, LOGGER) as sess:
        sess.reads_done.add(entries[0])

        async def scenario():
            watch = sess.loop.create_task(
                sess.live_watch_inputs(str(inputdir)) if package == 'jax'
                else sess.live_watch_inputs())
            deadline = time.time() + 20
            while time.time() < deadline and not sess.jobstack:
                await asyncio.sleep(0.05)
            watch.cancel()
            try:
                await watch
            except asyncio.CancelledError:
                pass
        sess.loop.run_until_complete(scenario())
        assert sess.jobstack == [entries[1]]
        assert sess.reads_found == 1
    assert [(t.path, t.mask) for t in created] == [(topdir, 0x8 | 0x80)]


def test_directory_snapshot_as_jax(tmp_path):
    from poreplex_tpu.pipeline.session import \
        ProcessingSession as JaxSession
    from poreplex_torch.pipeline.source import DirectorySource
    (tmp_path / 'a.fast5').write_bytes(b'x')
    (tmp_path / '.hidden.fast5').write_bytes(b'x')
    (tmp_path / 'notes.txt').write_bytes(b'x')
    (tmp_path / 'sub').mkdir()
    (tmp_path / 'sub' / 'b.FAST5').write_bytes(b'x')
    (tmp_path / '.cache').mkdir()
    (tmp_path / '.cache' / 'c.fast5').write_bytes(b'x')
    snapshot = DirectorySource(str(tmp_path)).snapshot()
    assert set(snapshot) == {'a.fast5', os.path.join('sub', 'b.FAST5')}
    assert snapshot == JaxSession._snapshot_tree(str(tmp_path), '.fast5')


def test_watchdog_flushes_a_stalled_partial_batch(tmp_path, monkeypatch):
    from poreplex_torch.pipeline.session import ProcessingSession
    heartbeat = 0.05
    monkeypatch.setattr(ProcessingSession, 'MIN_HEARTBEAT', heartbeat)
    config = session_config('torch', tmp_path, tmp_path, live=True,
                            batch_chunk_size=1000)
    entries = [('a.fast5', 'read-a'), ('b.fast5', 'read-b')]
    submitted = []

    with ProcessingSession(config, LOGGER) as sess:
        async def fake_batch(batchid, files):
            submitted.append((batchid, files))
        sess.run_process_batch = fake_batch

        async def scenario():
            for entry in entries:
                sess.queue_processing(entry)
            t0 = sess.loop.time()
            dog = sess.loop.create_task(sess.force_flushing_stalled_queue())
            while not submitted and sess.loop.time() - t0 < 5:
                await asyncio.sleep(0.01)
            elapsed = sess.loop.time() - t0
            dog.cancel()
            await dog
            return elapsed
        elapsed = sess.loop.run_until_complete(scenario())
    assert submitted == [(0, entries)]
    assert sess.jobstack == []
    # the first heartbeat sees the count move, two quiet ones follow
    assert elapsed >= 3 * heartbeat


def test_analysis_start_delay_holds_a_batch(tmp_path, monkeypatch):
    """A batch is analysed no sooner than analysis_start_delay seconds
    after it is submitted."""
    from poreplex_torch.pipeline.session import ProcessingSession
    from poreplex_torch.pipeline.source import MemorySource
    delay = 0.3
    started = []

    def fake_load(self, files):
        started.append(time.monotonic())
        return files

    def fake_analyze(self, files):
        return [{'filename': name, 'read_id': read_id,
                 'status': 'scaler_signal_too_short'}
                for name, read_id in files], {}
    # a batch's analysis starts with its PHASE A on a monitor thread
    monkeypatch.setattr(ProcessingSession, 'load_batch', fake_load)
    monkeypatch.setattr(ProcessingSession, 'analyze_batch', fake_analyze)
    reads = [types.SimpleNamespace(read_id='read-{}'.format(i))
             for i in range(3)]
    config = session_config('torch', tmp_path, tmp_path,
                            analysis_start_delay=delay)
    t0 = time.monotonic()
    printer = ProcessingSession.run(config, LOGGER, MemorySource(reads))
    assert printer is not None
    assert len(started) == 1 and started[0] - t0 >= delay


# ---------------------------------------------------------- memory source

@pytest.fixture(scope='module')
def simulated_reads():
    from poreplex_torch import simulate
    rng = np.random.default_rng(7)
    return [simulate.simulate_read(rng, polya_len=2400, barcode=i % 4)
            for i in range(3)]


def test_memory_source_writes_what_files_give(simulated_reads,
                                              tmp_path):
    from poreplex_torch import simulate
    from poreplex_torch.pipeline.session import ProcessingSession
    from poreplex_torch.pipeline.source import MemorySource
    indir = tmp_path / 'in'
    indir.mkdir()
    for i, read in enumerate(simulated_reads):
        simulate.write_single_read_fast5(
            str(indir / 'read{}.fast5'.format(i)), read)
    outputs = {}
    for name, source in (('files', None),
                         ('memory', MemorySource(simulated_reads))):
        outdir = tmp_path / name
        outdir.mkdir()
        config = session_config('torch', indir, outdir, barcoding=True,
                                trim_adapter=True, measure_polya=True)
        assert ProcessingSession.run(config, LOGGER, source) is not None
        outputs[name] = output_files(str(outdir))
    files, memory = outputs['files'], outputs['memory']
    assert set(files) == set(memory)

    def rows(summary, filenames):
        lines = summary.decode().splitlines()
        assert [line.split('\t')[0] for line in lines[1:]] == filenames
        return [line.split('\t')[1:] for line in lines]
    assert rows(memory['sequencing_summary.txt'],
                [MemorySource.FILENAME] * 3) == \
        rows(files['sequencing_summary.txt'],
             ['read{}.fast5'.format(i) for i in range(3)])
    for path in files:
        if path.startswith('fastq'):
            assert memory[path] == files[path], path
    assert [line.split('\t')[1] for line in
            memory['.processed-reads'].decode().splitlines()] == \
        [read.read_id for read in simulated_reads]


@pytest.mark.parametrize('sink', ['fast5_output', 'nanopolish_output',
                                  'dump_adapter_signals', 'dump_basecalls'])
def test_memory_source_refuses_file_sinks(sink, simulated_reads, tmp_path):
    from poreplex_torch.pipeline.session import ProcessingSession
    from poreplex_torch.pipeline.source import MemorySource
    config = session_config('torch', tmp_path, tmp_path, **{sink: True})
    with pytest.raises(ValueError, match=sink):
        ProcessingSession.run(config, LOGGER,
                              MemorySource(simulated_reads))
    assert os.listdir(str(tmp_path)) == []


# ------------------------------------------------------------- early stop

EARLY_STOP = re.compile(
    r"Early stopping: (\d+) out of (\d+) reads are not basecalled\. Please "
    r"check if the files are correctly analyzed, or add `--basecall' to "
    r"the command line\.")


@pytest.fixture(scope='module')
def unbasecalled_input(tmp_path_factory):
    from poreplex_tpu import simulate
    indir = tmp_path_factory.mktemp('no-basecall')
    simulate.make_fixture_dir(str(indir), n_reads=6, seed=3, basecall=None)
    return indir


def test_early_stop_message_as_jax(unbasecalled_input, tmp_path, capsys):
    """One batch of reads without basecalls, the trigger below its size:
    both sessions print the same message."""
    messages = {}
    for package, (_, session) in packages().items():
        outdir = tmp_path / package
        outdir.mkdir()
        config = session_config(package, unbasecalled_input, outdir,
                                nobasecall_stop_trigger=4)
        session.run(config, LOGGER)
        err = capsys.readouterr().err
        messages[package] = [line for line in err.splitlines()
                             if EARLY_STOP.search(line)]
    assert messages['torch'] == messages['jax']
    assert EARLY_STOP.search(messages['torch'][0]).groups() == ('6', '6')


def test_early_stop_stops_later_batches(unbasecalled_input, tmp_path,
                                        capsys):
    """Batches of 2, the trigger at 2: the session stops after the first
    batch, so the last one is never analysed, and it ends unfinished."""
    _, session = packages()['torch']
    config = session_config('torch', unbasecalled_input, tmp_path,
                            nobasecall_stop_trigger=2, batch_chunk_size=2)
    assert session.run(config, LOGGER) is None
    err = capsys.readouterr().err
    assert len([line for line in err.splitlines()
                if EARLY_STOP.search(line)]) == 1
    with open(str(tmp_path / 'sequencing_summary.txt')) as f:
        rows = f.read().splitlines()[1:]
    assert 2 <= len(rows) < 6
    assert all(row.split('\t')[10] == 'not_basecalled' for row in rows)
    assert not (tmp_path / '.processed-reads').exists()
