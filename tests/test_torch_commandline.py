"""The port's command line (``python -m poreplex_torch``, on the CPU) and
poreplex-tpu's (``poreplex-tpu --cpu``) on the fixture of
tests/test_torch_session.py (9 reads, one batch), with every sink this host
can run: both write the same set of files. Text files are equal byte for
byte; HDF5 files by content (every group, dataset and attribute, external
links by their targets): integer, string and position fields exactly, the
fields derived from the scaling within SCALED_RTOL; the logs equal once
the timestamps, the version and command lines, the stage timers and the
port's device line are left out and each run's output directory is named
alike.

Also: every option of poreplex-tpu's command line gives the same config
value in both packages (``--basecall`` and ``--align`` with stand-ins of
albacore, mappy and pysam) or, for a TPU knob, is unknown to the port;
without albacore, mappy or pysam both command lines stop ``--basecall``
and ``--align`` with the same message and exit code; the output
directory's y/N gate, -y, --resume and the tmpdir in both packages; and
the port's CLI without --cpu where there is no CUDA."""

import ast
import contextlib
import gzip
import json
import logging
import os
import re
import sys

import h5py
import numpy as np
import pytest
import yaml

from test_torch_session import reduce_shapes

OPTIONS = ['-y', '-q', '--barcoding', '--trim-adapter', '--polya',
           '--filter-chimera', '--fast5', '--nanopolish',
           '--dump-adapter-signals', '--dump-basecalled-events']
# the fields derived from the scaling (the adapter signals, scaled_mean,
# signal_scale, signal_shift): the scaling is held within 5e-5 of the JAX
# package's (tests/test_torch_engine.py), so these agree within
# SCALED_RTOL * max(1, |JAX value|)
SCALED_RTOL = 5e-5
SCALED_FIELDS = ('scaled_mean', 'signal_scale', 'signal_shift')
# the event dumps' 'spikes' attribute is the repr of the poly(A) tail's
# spikes, (length, three neighbouring event means) each: the count and the
# lengths are held exactly, the event means within SPIKES_RTOL, as
# tests/test_torch_unsplit.py holds them (an event mean of the poly(A)
# round can differ by an ulp from the JAX program's, ROADMAP Queue 3)
SPIKES_RTOL = 1e-5
# log lines that differ by design: the version and command lines name the
# package and its argv, the stage timers hold each package's own stages
# and times, and the port also names its device and its ingest worker
# count
LOG_SKIP = ('Starting poreplex-', 'Command line: ', 'stage ', ' * Device: ',
            ' * Ingest worker processes: ')


@contextlib.contextmanager
def jax_log_handlers():
    """Remove and close the log handlers poreplex-tpu's CLI adds to its
    logger (it never removes them itself)."""
    logger = logging.getLogger('poreplex_tpu')
    before = list(logger.handlers)
    try:
        yield
    finally:
        for handler in logger.handlers[:]:
            if handler not in before:
                logger.removeHandler(handler)
                handler.close()


def run_jax_cli(argv):
    from poreplex_tpu import commandline as jcli
    with pytest.MonkeyPatch.context() as mp, jax_log_handlers():
        mp.setattr(sys, 'argv', ['poreplex-tpu'] + argv)
        jcli.__main__()


def run_torch_cli(argv):
    from poreplex_torch import commandline
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, 'argv', ['poreplex-torch'] + argv)
        commandline.__main__()


def reduced_presets(tmp_path):
    """The default preset of each package at reduce_shapes' shapes, with
    absolute asset paths: YAML for poreplex-tpu, JSON for the port."""
    from poreplex_tpu.config import load_preset as jax_load_preset
    from poreplex_torch.config import load_preset
    jax_preset = jax_load_preset()
    reduce_shapes(jax_preset)
    torch_preset = load_preset()
    reduce_shapes(torch_preset)
    jax_path = tmp_path / 'reduced.yaml'
    jax_path.write_text(yaml.safe_dump(jax_preset))
    torch_path = tmp_path / 'reduced.json'
    torch_path.write_text(json.dumps(torch_preset))
    return str(jax_path), str(torch_path)


def make_fixture(indir):
    from poreplex_tpu import simulate
    simulate.make_fixture_dir(str(indir), n_reads=6, seed=20,
                              polya_len=2400)
    simulate.make_fixture_dir(str(indir / 'nested'), n_reads=3, seed=21,
                              multi_read=True, basecall='guppy')


def output_tree(outputdir):
    """(relative paths of the directories, {relative path of a file:
    absolute path})."""
    dirs, files = set(), {}
    for root, dirnames, names in os.walk(outputdir):
        for name in dirnames:
            dirs.add(os.path.relpath(os.path.join(root, name), outputdir))
        for name in names:
            path = os.path.join(root, name)
            files[os.path.relpath(path, outputdir)] = path
    return dirs, files


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """Both CLIs over one fixture: {package: (directories, files, log
    text)}."""
    base = tmp_path_factory.mktemp('cli')
    indir = base / 'in'
    make_fixture(indir)
    jax_preset, torch_preset = reduced_presets(base)
    runs = {}
    for package, run, preset in (('jax', run_jax_cli, jax_preset),
                                 ('torch', run_torch_cli, torch_preset)):
        out = base / ('out-' + package)
        run(['-i', str(indir), '-o', str(out), '-c', preset, '--cpu',
             '--device-batch-size', '8'] + OPTIONS)
        dirs, files = output_tree(str(out))
        with open(files['poreplex.log']) as f:
            runs[package] = dirs, files, f.read().replace(str(out), 'OUTDIR')
    return runs


TEXT_SUFFIXES = ('.txt', '.gz', '.fasta', '.readdb', '.index',
                 '.processed-reads')
HDF5_SUFFIXES = ('.h5', '.fast5')


def test_cli_writes_the_same_files(cli_runs):
    jdirs, jfiles, _ = cli_runs['jax']
    dirs, files, _ = cli_runs['torch']
    assert dirs == jdirs
    assert set(files) == set(jfiles)
    for path in files:
        assert path.endswith(TEXT_SUFFIXES + HDF5_SUFFIXES + ('.log',)), path
    assert {'.processed-reads', 'sequencing_summary.txt',
            'adapter-dumps/inventory.h5', 'adapter-dumps/part-0.h5',
            'events/inventory.h5', 'events/part-0.h5'} <= set(files)
    assert any(p.startswith('fast5/') for p in files)
    assert any(p.endswith('.fasta.index') for p in files)


def test_cli_text_files_identical(cli_runs):
    _, jfiles, _ = cli_runs['jax']
    _, files, _ = cli_runs['torch']
    texts = [p for p in files if p.endswith(TEXT_SUFFIXES)]
    for path in texts:
        with open(files[path], 'rb') as a, open(jfiles[path], 'rb') as b:
            assert a.read() == b.read(), path
    with open(files['.processed-reads']) as f:
        assert len(f.read().splitlines()) == 9
    with open(files['sequencing_summary.txt']) as f:
        rows = f.read().splitlines()
    assert len(rows) == 10
    # the filename column points into the FAST5 copies
    assert all(row.split('\t')[0].startswith('fast5/') for row in rows[1:])
    records = sum(len(gzip.open(files[p]).read().splitlines()) // 4
                  for p in texts if p.endswith('.fastq.gz'))
    assert records == 9


def h5_content(path):
    """{object path: (kind, ...)} of an HDF5 file, links not followed:
    ('link', file, path) for an external link, ('group', attrs) and
    ('dataset', array, attrs)."""
    out = {}
    with h5py.File(path, 'r') as f:
        def walk(group, prefix):
            for key in group:
                name = prefix + '/' + key
                link = group.get(key, getlink=True)
                if isinstance(link, h5py.ExternalLink):
                    out[name] = ('link', link.filename, link.path)
                    continue
                obj = group[key]
                attrs = {k: obj.attrs[k] for k in obj.attrs}
                if isinstance(obj, h5py.Group):
                    out[name] = ('group', attrs)
                    walk(obj, name)
                else:
                    out[name] = ('dataset', obj[()], attrs)
        out['/'] = ('group', {k: f.attrs[k] for k in f.attrs})
        walk(f, '')
    return out


def assert_values(got, ref, scaled, where):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype, where
    assert got.shape == ref.shape, where
    if scaled:
        err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
        bound = SCALED_RTOL * np.maximum(1.0, np.abs(ref.astype(np.float64)))
        assert np.all(err <= bound), (where, float(err.max()))
    elif got.dtype.names:
        for field in got.dtype.names:
            assert_values(got[field], ref[field], field in SCALED_FIELDS,
                          '{}[{}]'.format(where, field))
    else:
        assert np.array_equal(got, ref), where


def assert_spikes(got, ref, where):
    got, ref = ast.literal_eval(str(got)), ast.literal_eval(str(ref))
    assert len(got) == len(ref), where
    for spike, ref_spike in zip(got, ref):
        assert spike[0] == ref_spike[0], where
        np.testing.assert_allclose(spike[1:], ref_spike[1:],
                                   rtol=SPIKES_RTOL, err_msg=where)


def assert_h5_equal(path, ref_path, scaled_datasets):
    got, ref = h5_content(path), h5_content(ref_path)
    assert set(got) == set(ref), path
    for name, entry in got.items():
        ref_entry = ref[name]
        where = '{}:{}'.format(path, name)
        assert entry[0] == ref_entry[0], where
        if entry[0] == 'link':
            assert entry == ref_entry, where
            continue
        attrs, ref_attrs = entry[-1], ref_entry[-1]
        assert set(attrs) == set(ref_attrs), where
        for key, value in attrs.items():
            if key == 'spikes':
                assert_spikes(value, ref_attrs[key], where)
                continue
            assert_values(value, ref_attrs[key], key in SCALED_FIELDS,
                          '{} @{}'.format(where, key))
        if entry[0] == 'dataset':
            assert_values(entry[1], ref_entry[1],
                          scaled_datasets(name), where)


def test_cli_hdf5_files_match(cli_runs):
    _, jfiles, _ = cli_runs['jax']
    _, files, _ = cli_runs['torch']
    paths = sorted(p for p in files if p.endswith(HDF5_SUFFIXES))
    assert len(paths) >= 5
    for path in paths:
        # the adapter signals of the part file are scaled pooled frames
        adapter_part = path.startswith('adapter-dumps/part-')
        assert_h5_equal(files[path], jfiles[path],
                        lambda name: adapter_part and
                        name.startswith('/adapter/'))
    events = h5_content(files['events/part-0.h5'])
    tables = [v for k, v in events.items() if v[0] == 'dataset']
    assert len(tables) == 9
    assert all('polya_begin' in attrs for _, _, attrs in tables)
    catalog = h5_content(files['adapter-dumps/inventory.h5'])
    assert len(catalog['/catalog/adapter'][1]) == 9


def log_lines(text):
    """The log's messages without the timestamp column, less LOG_SKIP."""
    lines = [line[24:] for line in text.splitlines()]
    return [line for line in lines if not line.startswith(LOG_SKIP)]


def test_cli_logs_match(cli_runs):
    _, _, jlog = cli_runs['jax']
    _, _, log = cli_runs['torch']
    assert 'Starting poreplex-torch version' in log
    assert ' * Device: cpu' in log
    lines = log_lines(log)
    assert lines == log_lines(jlog)
    assert lines[-1] == 'Finished.'
    assert '==== Result Summary ====' in lines


# ---------------------------------------------------------------- options

# every option of poreplex-tpu's command line, and the arguments a case
# gives: options the port carries give the same config values in both
# packages (the keys of CONFIG_KEYS)
CARRIED = {
    '-i': [], '--input': [], '-o': [], '--output': [], '--cpu': [],
    '-c': ['-c', '{preset}'], '--config': ['--config', '{preset}'],
    '--trim-adapter': ['--trim-adapter'],
    '--minimum-length': ['--minimum-length', '23'],
    '--filter-chimera': ['--filter-chimera'],
    '--barcoding': ['--barcoding'],
    '--barcoding-quality-filter': ['--barcoding',
                                   '--barcoding-quality-filter', '9'],
    '--polya': ['--polya'],
    '--live': ['--live'],
    '--live-delay': ['--live', '--live-delay', '7'],
    '--fastq': ['--fastq'],
    '--fast5': ['--fast5'],
    '--fast5-batch-size': ['--fast5', '--fast5-batch-size', '100'],
    '--nanopolish': ['--nanopolish'],
    '--dump-adapter-signals': ['--dump-adapter-signals'],
    '--dump-basecalled-events': ['--dump-basecalled-events'],
    '--dashboard': ['--dashboard'],
    '--contig-aliases': ['--contig-aliases', 'aliases.txt'],
    '-q': ['-q'], '--quiet': ['--quiet'],
    '-y': [], '--yes': ['--yes'],
    '-p': ['-p', '3'], '--parallel': ['--parallel', '0'],
    '--device-batch-size': ['--device-batch-size', '64'],
    '--wire-precision': ['--wire-precision', 'fast'],
    '--tmpdir': ['--tmpdir', '{tmp}'],
    '--batch-size': ['--batch-size', '64'],
    '--resume': ['--resume'],
    # one process: a rank count of 1 joins no process group
    '--mesh-shape': ['--mesh-shape', '2'],
    '--num-nodes': ['--num-nodes', '1'],
    '--node-rank': ['--node-rank', '0'],
    '--coordinator': ['--coordinator', '127.0.0.1:1'],
}
# options whose stages need packages this host may lack, carried with the
# stand-ins of tests/test_torch_albacore.py and tests/test_torch_alignment.py
# installed: (arguments, the stand-ins)
WITH_PACKAGES = {
    '--basecall': (['--basecall'], ('albacore',)),
    '--align': (['--align', '{mmi}', '--dashboard'], ('mappy', 'pysam')),
}
# a package missing -> the option that needs it and both CLIs' message
ABSENT = {
    'albacore': ('--basecall', 'ERROR: On-the-fly basecalling '
                 '(--basecall) requires the ONT albacore package.'),
    'mappy': ('--align', 'ERROR: Real-time alignment (--align) requires '
              'mappy and pysam.'),
    'pysam': ('--align', 'ERROR: Real-time alignment (--align) requires '
              'mappy and pysam.'),
}
# TPU knobs the port does not add: its parser refuses them
TPU_KNOBS = {'--pallas': ['--pallas', 'never'], '--prewarm': ['--prewarm']}
# options that print and exit
EXITING = ('--version', '-h', '--help')
CONFIG_KEYS = (
    'quiet', 'interactive', 'inputdir', 'outputdir', 'live',
    'analysis_start_delay', 'dashboard', 'contig_aliases', 'tmpdir',
    'cleanup_tmpdir', 'barcoding', 'barcoding_quality_filter',
    'measure_polya', 'filter_unsplit_reads', 'batch_chunk_size',
    'albacore_onthefly', 'dump_adapter_signals', 'dump_basecalls',
    'fastq_output', 'fast5_output', 'fast5_batch_size', 'nanopolish_output',
    'trim_adapter', 'minimum_sequence_length', 'minimap2_index',
    'device_batch_size', 'wire_precision', 'resume', 'parallel',
    'nobasecall_stop_trigger', 'label_names', 'barcode_names',
    'output_layout', 'mesh_shape', 'num_nodes', 'node_rank', 'coordinator')
PRESET_KEYS = ('segmentation', 'polya_dwell', 'unsplit_read_detection')


def jax_option_strings(capsys):
    with pytest.raises(SystemExit):
        run_jax_cli(['-h'])
    return set(re.findall(r'(?<![\w-])(--?[a-z][a-z0-9-]*)',
                          capsys.readouterr().out))


def test_option_table_covers_every_jax_option(capsys):
    listed = set(CARRIED) | set(WITH_PACKAGES) | set(TPU_KNOBS) | \
        set(EXITING)
    assert jax_option_strings(capsys) == listed


def captured_config(run, argv, package):
    """The config dict a CLI hands its session, with the session's run
    replaced by a stub."""
    if package == 'jax':
        from poreplex_tpu.pipeline.session import ProcessingSession
    else:
        from poreplex_torch.pipeline.session import ProcessingSession
    seen = {}

    def fake_run(config, logger, *args):
        seen['config'] = dict(config)
        seen['tmpdir_made'] = os.path.isdir(config['tmpdir'])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ProcessingSession, 'run', staticmethod(fake_run))
        run(argv)
    return seen


@pytest.fixture(scope='module')
def option_presets(tmp_path_factory):
    return reduced_presets(tmp_path_factory.mktemp('option-presets'))


@pytest.mark.parametrize('option', sorted(CARRIED))
def test_carried_option_gives_the_same_config(option, tmp_path,
                                              option_presets, capsys):
    indir = tmp_path / 'in'
    indir.mkdir()
    configs = {}
    for package, run, preset in (
            ('jax', run_jax_cli, option_presets[0]),
            ('torch', run_torch_cli, option_presets[1])):
        out = tmp_path / package
        extra = [arg.format(preset=preset, tmp=str(tmp_path / (package +
                                                              '-tmp')))
                 for arg in CARRIED[option]]
        argv = ['-i', str(indir), '-o', str(out), '--cpu'] + extra
        if '--yes' not in extra:
            argv.append('-y')
        config = captured_config(run, argv, package)['config']
        # the output paths, relative to each run's own directory
        for key in ('outputdir', 'tmpdir'):
            config[key] = os.path.relpath(config[key], str(tmp_path))
            config[key] = config[key].replace(package, 'PKG', 1)
        configs[package] = config
    got, ref = configs['torch'], configs['jax']
    assert got['device'] == 'cpu'
    for key in CONFIG_KEYS:
        assert got[key] == ref[key], key
    if option in ('-c', '--config'):
        for key in PRESET_KEYS:
            assert got[key] == ref[key], key
        assert got['signal_processing']['scaler_input_length'] == \
            ref['signal_processing']['scaler_input_length'] == 3000
    if option == '--dashboard':
        err = capsys.readouterr().err
        assert err.count('WARNING: Dashboard is turned off') == 2


def install_stand_ins(monkeypatch, tmp_path, names):
    """The stand-ins of the packages ``names`` in sys.modules."""
    from test_torch_albacore import install_albacore
    from test_torch_alignment import PYSAM, make_mappy
    stand_ins = {'mappy': make_mappy({}), 'pysam': PYSAM}
    for name in names:
        if name == 'albacore':
            install_albacore(monkeypatch, tmp_path / 'albacore-data',
                             lambda *args: [])
        else:
            monkeypatch.setitem(sys.modules, name, stand_ins[name])


@pytest.mark.parametrize('option', sorted(WITH_PACKAGES))
def test_package_option_gives_the_same_config(option, tmp_path,
                                              option_presets):
    """With the stand-ins, the same config in both packages: albacore's
    configuration written into each output directory alike, its version,
    the index and the dashboard kept on with --align."""
    from test_torch_alignment import write_mmi
    indir = tmp_path / 'in'
    indir.mkdir()
    mmi = write_mmi(tmp_path / 'ref.mmi', {'chr1': 100})
    argv, packages = WITH_PACKAGES[option]
    configs, cfg_texts = {}, {}
    for package, run in (('jax', run_jax_cli), ('torch', run_torch_cli)):
        out = tmp_path / package
        with pytest.MonkeyPatch.context() as mp:
            install_stand_ins(mp, tmp_path, packages)
            config = captured_config(
                run, ['-i', str(indir), '-o', str(out), '--cpu', '-y'] +
                [arg.format(mmi=mmi) for arg in argv], package)['config']
        for key in ('outputdir', 'tmpdir', 'albacore_configuration'):
            if config.get(key):
                config[key] = os.path.relpath(config[key], str(out))
        configs[package] = config
        cfg = out / 'albacore-configuration.cfg'
        cfg_texts[package] = cfg.read_text() if cfg.exists() else None
    got, ref = configs['torch'], configs['jax']
    for key in CONFIG_KEYS + ('albacore_configuration', 'albacore_version'):
        assert got.get(key) == ref.get(key), key
    assert cfg_texts['torch'] == cfg_texts['jax']
    if option == '--basecall':
        assert got['albacore_onthefly'] and \
            got['albacore_configuration'] == 'albacore-configuration.cfg'
        assert got['albacore_version'] == '2.3.4'
        assert 'min_qscore = 0' in cfg_texts['torch']
    else:
        assert got['minimap2_index'] == mmi and got['dashboard']
        assert not got['fastq_output']


@pytest.mark.parametrize('package', sorted(ABSENT))
def test_option_stops_without_its_package(package, tmp_path, monkeypatch,
                                          capsys):
    """With the package missing (and the others' stand-ins there), both
    command lines stop with the same message and exit code, before any
    read is read."""
    from test_torch_alignment import write_mmi
    install_stand_ins(monkeypatch, tmp_path, ['mappy', 'pysam'])
    monkeypatch.setitem(sys.modules, package, None)
    option, message = ABSENT[package]
    argv = [option]
    if option == '--align':
        argv.append(write_mmi(tmp_path / 'ref.mmi', {'chr1': 100}))
    indir = tmp_path / 'in'
    indir.mkdir()
    stops = []
    for name, run in (('jax', run_jax_cli), ('torch', run_torch_cli)):
        out = tmp_path / name
        with pytest.raises(SystemExit) as exc:
            run(['-i', str(indir), '-o', str(out), '--cpu', '-y', '-q'] +
                argv)
        err = capsys.readouterr().err
        stops.append((exc.value.code, err.strip().splitlines()[-1],
                      sorted(p.name for p in out.iterdir())))
    assert stops[0] == stops[1]
    code, last_line, written = stops[1]
    assert code == 1 and last_line == message
    assert 'poreplex.log' in written
    assert 'sequencing_summary.txt' not in written


@pytest.mark.parametrize('magic', [b'NOPE', b'MMI'])
def test_bad_index_stops_both_clis(magic, tmp_path, monkeypatch, capsys):
    install_stand_ins(monkeypatch, tmp_path, ['mappy', 'pysam'])
    bad = tmp_path / 'bad.mmi'
    bad.write_bytes(magic)
    indir = tmp_path / 'in'
    indir.mkdir()
    stops = []
    for name, run in (('jax', run_jax_cli), ('torch', run_torch_cli)):
        with pytest.raises(SystemExit) as exc:
            run(['-i', str(indir), '-o', str(tmp_path / name), '--cpu', '-y',
                 '-q', '--align', str(bad)])
        stops.append((exc.value.code, capsys.readouterr().err.strip()))
    assert stops[0] == stops[1] == (
        1, 'ERROR: Could not load a minimap2 index from {}.'.format(bad))


@pytest.mark.parametrize('trainer', ['train_demux', 'train_scaler'])
def test_trainer_data_parallel_stops(trainer, tmp_path):
    """The trainers' --data-parallel with --cpu trains on a world of one
    gloo rank (the CPU mesh of parallel.mesh.select_devices), spawned by
    the trainer and bounded here by the ranks' time limit, and stops with
    a checkpoint that loads in both packages' models."""
    import subprocess
    from test_torch_distributed import RANK_TIMEOUT
    from test_torch_training import (assert_demux_models_agree,
                                     assert_scaler_models_agree)
    from poreplex_torch.training import data
    path = tmp_path / 'model.npz'
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, '-m', 'poreplex_torch.training.' + trainer, '-o',
         str(path), '--data-parallel', '--cpu', '--steps', '1',
         '--batch-size', '4'],
        capture_output=True, text=True, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS='2'),
        timeout=RANK_TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'step    0 loss' in out.stdout
    rng = np.random.RandomState(2)
    if trainer == 'train_demux':
        windows, _ = data.demux_dataset(2, rng)
        assert_demux_models_agree(str(path), windows[:6])
    else:
        heads, _ = data.scaler_dataset(4, rng, pooled_length=60)
        assert_scaler_models_agree(str(path), heads)


@pytest.mark.parametrize('option', sorted(TPU_KNOBS))
def test_tpu_knob_is_unknown(option, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        run_torch_cli(['-i', str(tmp_path), '-o', str(tmp_path / 'out'),
                       '--cpu'] + TPU_KNOBS[option])
    assert exc.value.code == 2
    assert 'unrecognized arguments' in capsys.readouterr().err


@pytest.mark.parametrize('option', EXITING)
def test_printing_options_exit_zero(option, capsys):
    outputs = []
    for run in (run_jax_cli, run_torch_cli):
        with pytest.raises(SystemExit) as exc:
            run([option])
        assert exc.value.code == 0
        outputs.append(capsys.readouterr().out)
    assert 'poreplex-torch' in outputs[1]
    if option == '--version':
        assert outputs[1].startswith('poreplex-torch version')


# ------------------------------------------------------ output directory

def gate_run(package, tmp_path, argv, answers=()):
    """One CLI run with its session stubbed, over an output directory that
    holds a file; input() answers from ``answers``. Returns what the stub
    saw, or the SystemExit code."""
    run = run_jax_cli if package == 'jax' else run_torch_cli
    indir = tmp_path / 'in'
    indir.mkdir(exist_ok=True)
    out = tmp_path / 'out'
    out.mkdir(exist_ok=True)
    (out / 'old.txt').write_text('earlier run')
    answers = list(answers)
    prompts = []

    def fake_input(prompt):
        prompts.append(prompt)
        return answers.pop(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr('builtins.input', fake_input)
        try:
            seen = captured_config(run, ['-i', str(indir), '-o', str(out),
                                         '--cpu', '-q'] + argv, package)
        except SystemExit as exc:
            seen = {'exit': exc.code}
    seen['prompts'] = prompts
    seen['kept'] = (out / 'old.txt').exists()
    return seen


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_no_keeps_the_output_and_exits_1(package, tmp_path):
    seen = gate_run(package, tmp_path, [], answers=['n'])
    assert seen['exit'] == 1
    assert seen['kept'] and len(seen['prompts']) == 1
    assert 'is not empty. Clear it? (y/N)' in seen['prompts'][0]


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_yes_clears_the_output(package, tmp_path):
    seen = gate_run(package, tmp_path, [], answers=['maybe', 'y'])
    assert 'config' in seen and not seen['kept']
    assert len(seen['prompts']) == 2


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_dash_y_clears_without_asking(package, tmp_path):
    seen = gate_run(package, tmp_path, ['-y'])
    assert 'config' in seen and not seen['kept'] and not seen['prompts']


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_resume_keeps_the_output(package, tmp_path):
    seen = gate_run(package, tmp_path, ['--resume'])
    assert 'config' in seen and seen['kept'] and not seen['prompts']


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_tmpdir_made_and_removed(package, tmp_path):
    tmpdir = tmp_path / 'scratch-space'
    seen = gate_run(package, tmp_path, ['-y', '--tmpdir', str(tmpdir)])
    assert seen['tmpdir_made'] and seen['config']['cleanup_tmpdir']
    assert not tmpdir.exists()
    # a tmpdir that was there before is kept
    tmpdir.mkdir()
    seen = gate_run(package, tmp_path, ['-y', '--tmpdir', str(tmpdir)])
    assert not seen['config']['cleanup_tmpdir'] and tmpdir.is_dir()
    # without --tmpdir it is OUTDIR/tmp
    seen = gate_run(package, tmp_path, ['-y'])
    assert seen['config']['tmpdir'] == str(tmp_path / 'out' / 'tmp')
    assert not (tmp_path / 'out' / 'tmp').exists()


def test_cuda_without_cuda_names_cpu(tmp_path, capsys):
    import torch
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as exc:
        run_torch_cli(['-i', str(tmp_path), '-o', str(tmp_path / 'out'),
                       '-y', '-q'])
    assert exc.value.code not in (0, None)
    err = capsys.readouterr().err
    assert 'CUDA is not available' in err and '--cpu' in err
