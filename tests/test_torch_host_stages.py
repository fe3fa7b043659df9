"""Whole sessions with the host stages, through both command lines on the
CPU (``poreplex-tpu --cpu`` and ``python -m poreplex_torch --cpu``) on one
FAST5 fixture (6 single-read files and a multi-read file of 3, albacore
basecalls), with the same stand-ins of albacore, mappy, pysam and curses
(tests/test_torch_albacore.py, test_torch_alignment.py,
test_torch_dashboard.py):

- ``--basecall`` with poly(A): the stand-in albacore returns each read's
  basecall from its file (found by its signal), nothing for one read and
  an error for another. The summary, the FASTQ streams, the manifest and
  albacore's configuration are equal byte for byte, and albacore is
  handed the same (name, signal, metadata) for each read in both, the
  signal equal bit for bit to range / digitisation * (raw + offset) in
  float32;
- ``--align`` with ``--fastq``, ``--trim-adapter`` and the dashboard on a
  stand-in terminal: every ``bam/*.bam`` (SAM text from the
  stand-in pysam) is equal byte for byte, each holds exactly the reads
  the summary puts in its (label, barcode) stream, and the tallies fed to
  the dashboard are equal and add up to the rows.

Tolerance is zero: these stages decide, they do not compute."""

import gzip
import os

import numpy as np
import pytest

from test_torch_albacore import albacore_result, install_albacore
from test_torch_alignment import install_aligner, revcomp, write_mmi
from test_torch_commandline import (reduced_presets, run_jax_cli,
                                    run_torch_cli)
from test_torch_dashboard import install_curses
from test_torch_session import output_files

CLIS = (('jax', run_jax_cli), ('torch', run_torch_cli))


def make_fixture(indir):
    from poreplex_tpu import simulate
    simulate.make_fixture_dir(str(indir), n_reads=6, seed=20,
                              polya_len=2400)
    simulate.make_fixture_dir(str(indir / 'nested'), n_reads=3, seed=21,
                              multi_read=True)


def fixture_reads(indir):
    """{read id: (pA signal as poreplex-tpu's reader gives it, the file's
    basecall, its albacore Events table)} of every read of the fixture."""
    from poreplex_tpu import fast5
    reads = {}
    for root, _, names in os.walk(str(indir)):
        for name in sorted(names):
            path = os.path.join(root, name)
            for _, read_id in fast5.get_read_ids(path):
                with fast5.Fast5Reader(path, read_id) as reader:
                    events = reader.handle[
                        reader.analyses_node + '/Basecall_1D_000/'
                        'BaseCalled_template/Events'][()]
                    reads[read_id] = (reader.get_raw_data(),
                                      reader.get_basecall(), events)
    assert len(reads) == 9
    return reads


def run_clis(base, indir, argv, install):
    """Both CLIs over ``indir`` with ``argv``, each with the stand-ins that
    ``install(monkeypatch, package)`` puts in place (undone after the
    run). Returns {package: (the output files, install's result)}."""
    runs = {}
    for (package, run), preset in zip(CLIS, reduced_presets(base)):
        out = base / ('out-' + package)
        with pytest.MonkeyPatch.context() as mp:
            installed = install(mp, package)
            run(['-i', str(indir), '-o', str(out), '-c', preset, '--cpu',
                 '-y', '--device-batch-size', '8', '--barcoding'] + argv)
        runs[package] = output_files(str(out)), installed
    return runs


# ------------------------------------------------------------ --basecall

@pytest.fixture(scope='module')
def basecall_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('basecall')
    indir = base / 'in'
    make_fixture(indir)
    reads = fixture_reads(indir)
    by_signal = {signal.tobytes(): read_id
                 for read_id, (signal, _, _) in reads.items()}
    no_call, failing = sorted(reads)[:2]

    def basecaller(name, rawdata, meta):
        read_id = by_signal[rawdata.tobytes()]
        if read_id == no_call:
            return []
        if read_id == failing:
            raise RuntimeError('albacore failed on ' + read_id)
        _, bcall, events = reads[read_id]
        return [albacore_result(bcall['sequence'], bcall['qstring'], events,
                                bcall['mean_qscore'])]

    runs = run_clis(base, indir, ['-q', '--basecall', '--polya'],
                    lambda mp, package: install_albacore(
                        mp, base / ('albacore-' + package), basecaller))
    return runs, reads, (no_call, failing)


def test_basecall_outputs_identical(basecall_runs):
    runs, reads, _ = basecall_runs
    got, ref = runs['torch'][0], runs['jax'][0]
    assert set(got) == set(ref)
    compared = [path for path in got if path != 'poreplex.log']
    assert {'sequencing_summary.txt', '.processed-reads',
            'albacore-configuration.cfg'} <= set(compared)
    assert any(path.startswith('fastq' + os.sep) for path in compared)
    for path in compared:
        assert got[path] == ref[path], path
    rows = got['sequencing_summary.txt'].decode().splitlines()
    assert len(rows) == 1 + 9 - 1      # the failing read has no row
    assert rows[0].endswith('\tpolya_dwell')
    fastq = sum(len(gzip.decompress(got[p]).splitlines()) // 4
                for p in got if p.startswith('fastq' + os.sep))
    assert fastq == 7


def test_basecall_statuses(basecall_runs):
    runs, _, (no_call, failing) = basecall_runs
    rows = runs['torch'][0]['sequencing_summary.txt'].decode().splitlines()
    header = rows[0].split('\t')
    status = {row.split('\t')[header.index('read_id')]:
              row.split('\t')[header.index('status')] for row in rows[1:]}
    assert status[no_call] == 'not_basecalled'
    assert failing not in status
    assert list(status.values()).count('okay') == 7


def test_albacore_gets_the_same_reads(basecall_runs):
    runs, reads, _ = basecall_runs
    ref = runs['jax'][1].calls
    got = runs['torch'][1].calls
    assert len(got) == len(ref) == 9
    names = sorted(name for name, _, _ in got)
    assert names == ['batch0'] * 3 + ['read{:03d}'.format(i)
                                      for i in range(6)]
    signals = {signal.tobytes() for signal, _, _ in reads.values()}
    for (name, rawdata, meta), (jname, jrawdata, jmeta) in zip(got, ref):
        assert (name, meta) == (jname, jmeta)
        assert rawdata.dtype == jrawdata.dtype == np.float32
        assert rawdata.tobytes() == jrawdata.tobytes()
        assert rawdata.tobytes() in signals
        assert set(meta) == {'channel_id', 'start_time', 'duration',
                             'sampling_rate'}
        assert meta['duration'] == len(rawdata)


def test_kept_signal_is_the_readers(tmp_path):
    """The port's PHASE A keeps the DAC and gives albacore what
    poreplex-tpu's reader gives it, for a wide DAC too."""
    from poreplex_torch import fast5, simulate
    rng = np.random.default_rng(3)
    read = simulate.simulate_read(rng)
    reader = simulate.MemoryRead(read)
    for raw in (read.raw_dac, read.raw_dac.astype(np.int32),
                read.raw_dac.astype(np.float32)):
        kept = fast5.KeptRead(reader, raw)
        want = np.asarray(simulate.RANGE / simulate.DIGITISATION *
                          (raw + simulate.OFFSET), np.float32)
        assert kept.get_raw_data().tobytes() == want.tobytes()
    assert reader.get_raw_data().tobytes() == \
        np.asarray(simulate.RANGE / simulate.DIGITISATION *
                   (read.raw_dac + simulate.OFFSET), np.float32).tobytes()
    assert (kept.channel_number, kept.start_time, kept.duration,
            kept.sampling_rate) == (reader.channel_number,
                                    reader.start_time, reader.duration,
                                    reader.sampling_rate)


# --------------------------------------------------------------- --align

def contigs_of(reads):
    """Contigs holding some reads' basecalls in the DNA alphabet: one in
    three forward (the first also in a second contig), one in three as
    its reverse complement, the rest nowhere."""
    contigs = {}
    for i, read_id in enumerate(sorted(reads)):
        dna = reads[read_id][1]['sequence'].replace('U', 'T')
        if i % 3 == 0:
            contigs['tx{}|gene{}'.format(i, i)] = 'GATTACA' + dna + 'CCGG'
            if i == 0:
                contigs['copy0'] = 'TT' + dna
        elif i % 3 == 1:
            contigs['tx{}'.format(i)] = 'AAAAC' + revcomp(dna) + 'GT'
    return contigs


@pytest.fixture(scope='module')
def align_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('align')
    indir = base / 'in'
    make_fixture(indir)
    reads = fixture_reads(indir)
    contigs = contigs_of(reads)
    mmi = write_mmi(base / 'ref.mmi', contigs)
    aliases = base / 'aliases.txt'
    aliases.write_text('tx0\tfirst-transcript\n')

    def install(mp, package):
        from poreplex_tpu import dashboard as jax_dashboard
        from poreplex_torch import dashboard
        module = jax_dashboard if package == 'jax' else dashboard
        mappy = install_aligner(mp, contigs)
        curses, screen = install_curses(mp)
        fed = []
        feed = module.DashboardView.feed_mapped

        def feed_mapped(view, rescounts):
            fed.append({k: dict(v) for k, v in rescounts.items()})
            return feed(view, rescounts)
        mp.setattr(module.DashboardView, 'feed_mapped', feed_mapped)
        return mappy.Aligner.queries, fed, curses.calls

    runs = run_clis(base, indir, ['--align', mmi, '--fastq',
                                  '--trim-adapter', '--dashboard',
                                  '--contig-aliases', str(aliases)],
                    install)
    return runs, reads, contigs


def bam_rows(files):
    """{stream path under bam/: [SAM rows]} of every BAM written."""
    return {path[len('bam/'):-len('.bam')]: [
        line.split('\t') for line in files[path].decode().splitlines()
        if not line.startswith('@')]
        for path in files if path.startswith('bam' + os.sep)}


def test_bam_files_identical(align_runs):
    runs, _, contigs = align_runs
    got, ref = runs['torch'][0], runs['jax'][0]
    assert set(got) == set(ref)
    bams = sorted(path for path in got if path.endswith('.bam'))
    assert 'bam/pass/BC1.bam' in bams and 'bam/fail/undetermined.bam' in bams
    for path in got:
        if path != 'poreplex.log':
            assert got[path] == ref[path], path
    header = got[bams[0]].decode().splitlines()[:len(contigs) + 1]
    assert header[-1] == ('@PG\tID:minimap2\tPN:minimap2\tCL:minimap2 -w 10 '
                          '-k 15\tDS:minimap2 invoked by poreplex-tpu')


def test_streams_hold_their_reads(align_runs):
    runs, _, _ = align_runs
    files = runs['torch'][0]
    rows = files['sequencing_summary.txt'].decode().splitlines()
    header = rows[0].split('\t')
    streams = {}
    for row in rows[1:]:
        fields = dict(zip(header, row.split('\t')))
        streams.setdefault(os.path.join(fields['label'], fields['barcode']),
                           set()).add(fields['read_id'])
    fastq = {}
    for path in files:
        if path.startswith('fastq' + os.sep):
            lines = gzip.decompress(files[path]).decode().splitlines()
            for i in range(0, len(lines), 4):
                fastq[lines[i][1:]] = lines[i + 1]
    bams = bam_rows(files)
    for stream, names in bams.items():
        with_sequence = {name for name in streams.get(stream, ())
                         if name in fastq}
        assert {row[0] for row in bams[stream]} == with_sequence, stream
    # each read with a sequence was mapped once, as its FASTQ record
    # (adapter trimmed) holds it
    queries = runs['torch'][1][0]
    assert sorted(queries) == sorted(seq.replace('U', 'T')
                                     for seq in fastq.values())
    flags = {int(row[1]) for rows in bams.values() for row in rows}
    assert {0, 4, 16, 256} <= flags


def test_dashboard_tallies_identical(align_runs):
    runs, _, _ = align_runs
    _, fed, calls = runs['torch'][1]
    _, jfed, jcalls = runs['jax'][1]
    assert fed == jfed and calls == jcalls
    assert calls[:2] == ['noecho', 'cbreak'] and calls[-1] == 'endwin'
    mapped = sum(len(contigs) for feed in fed
                 for contigs in feed['mapped'].values())
    unmapped = sum(n for feed in fed for n in feed['unmapped'].values())
    failed = sum(n for feed in fed for n in feed['failed'].values())
    rows = [row for stream in bam_rows(runs['torch'][0]).values()
            for row in stream]
    assert mapped == len({row[0] for row in rows if row[1] in ('0', '16')})
    assert unmapped == len({row[0] for row in rows if row[1] == '4'})
    assert mapped + unmapped + failed == 9
    assert mapped and unmapped
