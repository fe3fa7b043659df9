"""The port's native FAST5 reader (poreplex_torch/csrc/fast5_ingest.cc
through poreplex_torch/fast5_native.py) against the port's h5py reader and
against poreplex-tpu's native reader: metadata, raw DAC signal, and the
basecall's sequence, qualities and event columns must be exactly equal on
the port's simulated fixtures, multi-read and single-read, for two seeds.
Guppy Move tables are left to h5py ('fallback'); a child name holding a
newline is listed whole (the port separates names with NUL); the library
builds with g++ into build/poreplex_torch_native/, also when two
processes build it at once."""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from poreplex_tpu import fast5_native as jax_native
from poreplex_torch import fast5, fast5_native, simulate
from poreplex_torch.pipeline.ingest import EVENT_COLUMNS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = ('duration', 'start_time', 'channel_number', 'run_id', 'sample_id',
        'digitisation', 'offset', 'range', 'sampling_rate')
SCALARS = ('sequence', 'qstring', 'block_stride', 'sequence_length',
           'mean_qscore', 'num_events', 'first_sample_template')


@pytest.fixture(scope='module')
def lib():
    lib = fast5_native.get_library()
    assert lib is not None, 'the native reader did not build or load'
    return lib


@pytest.fixture(scope='module', params=[31, 47])
def fixtures(request, tmp_path_factory):
    """(directory, entries): a multi-read file of four reads and two
    single-read files from one seed."""
    seed = request.param
    d = str(tmp_path_factory.mktemp('native-{}'.format(seed)))
    entries = simulate.make_fixture_dir(d, n_reads=4, seed=seed,
                                        multi_read=True,
                                        transcript_len=3000)
    entries += [(os.path.join('single', name), read_id)
                for name, read_id in simulate.make_fixture_dir(
                    os.path.join(d, 'single'), n_reads=2, seed=seed + 1,
                    transcript_len=3000)]
    return d, entries


def read_native(module, path, read_id):
    """(meta, raw DAC, basecall) of one read through a native module."""
    nf = module.NativeFast5.open(path)
    assert nf is not None
    try:
        nodes = nf.nodes_for(read_id)
        assert nodes is not None
        meta = nf.read_meta(*nodes[:3])
        raw = nf.read_signal(nodes[3], meta['duration'])
        bcall = nf.read_basecall(nodes[4])
    finally:
        nf.close()
    return meta, raw, bcall


def test_native_reader_matches_h5py_and_jax(lib, fixtures):
    d, entries = fixtures
    assert len(entries) == 6
    for filename, read_id in entries:
        path = os.path.join(d, filename)
        meta, raw, bcall = read_native(fast5_native, path, read_id)
        jmeta, jraw, jbcall = read_native(jax_native, path, read_id)
        with fast5.Fast5Reader(path, read_id) as f5:
            assert meta['read_id'] == read_id
            for key in META:
                assert meta[key] == getattr(f5, key) == jmeta[key], key
            ref_raw = f5.get_raw_dac()
            ref = f5.get_basecall(columns=EVENT_COLUMNS)
        assert raw.dtype == ref_raw.dtype == np.int16
        np.testing.assert_array_equal(raw, ref_raw)
        np.testing.assert_array_equal(raw, jraw)
        for key in SCALARS:
            assert bcall[key] == ref[key] == jbcall[key], key
        for col in EVENT_COLUMNS:
            assert bcall['events'][col].dtype == ref['events'][col].dtype
            np.testing.assert_array_equal(bcall['events'][col],
                                          ref['events'][col])
            np.testing.assert_array_equal(bcall['events'][col],
                                          jbcall['events'][col])
        np.testing.assert_array_equal(bcall['events']['model_state'],
                                      jbcall['events']['model_state'])


def test_short_buffer_is_sized_from_the_dataset(lib, fixtures):
    d, entries = fixtures
    filename, read_id = entries[0]
    nf = fast5_native.NativeFast5.open(os.path.join(d, filename))
    try:
        nodes = nf.nodes_for(read_id)
        duration = nf.read_meta(*nodes[:3])['duration']
        full = nf.read_signal(nodes[3], duration)
        assert len(full) == duration > 10
        np.testing.assert_array_equal(nf.read_signal(nodes[3], 10), full)
        assert nf.nodes_for('no-such-read') is None
    finally:
        nf.close()


def test_guppy_basecall_falls_back(lib, tmp_path):
    d = str(tmp_path / 'guppy')
    entries = simulate.make_fixture_dir(d, n_reads=2, seed=33,
                                        basecall='guppy', multi_read=True,
                                        transcript_len=3000)
    nf = fast5_native.NativeFast5.open(os.path.join(d, entries[0][0]))
    try:
        for _, read_id in entries:
            nodes = nf.nodes_for(read_id)
            assert nf.read_meta(*nodes[:3])['read_id'] == read_id
            assert nf.read_basecall(nodes[4]) == 'fallback'
    finally:
        nf.close()
    with fast5.Fast5Reader(os.path.join(d, entries[0][0]),
                           entries[0][1]) as f5:
        assert len(f5.get_basecall()['events']) > 0


def test_child_name_with_a_newline_is_listed_whole(lib, tmp_path):
    """An HDF5 link name may hold a newline: the port's listing separates
    names with NUL and keeps it whole, where poreplex-tpu's newline-joined
    listing splits it in two (a departure on purpose)."""
    path = str(tmp_path / 'names.fast5')
    with h5py.File(path, 'w') as f:
        for name in ('Basecall_1D_000', 'odd\nname', 'Segmentation_000'):
            f.create_group('Analyses/' + name)
        f.create_group('Empty')
    nf = fast5_native.NativeFast5.open(path)
    jnf = jax_native.NativeFast5.open(path)
    try:
        assert nf.list_children('Analyses') == [
            'Basecall_1D_000', 'Segmentation_000', 'odd\nname']
        assert nf.list_children('Empty') == []
        assert jnf.list_children('Analyses') == [
            'Basecall_1D_000', 'Segmentation_000', 'odd', 'name']
        # too small a buffer is a failure, not a truncated list
        assert nf.list_children('Analyses', cap=20) is None
    finally:
        nf.close()
        jnf.close()


def test_library_builds_into_the_build_directory(lib):
    path = fast5_native.library_path()
    assert path.startswith(os.path.join(REPO, 'build',
                                        'poreplex_torch_native',
                                        'fast5_ingest-'))
    assert path.endswith('.so') and os.path.isfile(path)
    assert fast5_native.build_library() == path
    assert lib.f5i_available() == 1


BUILD = ('import sys; from poreplex_torch import fast5_native; '
         'fast5_native.BUILD_DIR = sys.argv[1]; '
         'print(fast5_native.build_library())')


def test_concurrent_builds_rename_into_place(tmp_path):
    """Two processes building at once each compile to a private name and
    rename it into place: both end with the one library, no partial file
    is left, and it loads."""
    build_dir = str(tmp_path / 'native')
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, '-c', BUILD, build_dir],
                              stdout=subprocess.PIPE, text=True, env=env,
                              cwd=REPO)
             for _ in range(2)]
    outs = [proc.communicate(timeout=120)[0].strip() for proc in procs]
    assert [proc.returncode for proc in procs] == [0, 0]
    name = os.path.basename(fast5_native.library_path())
    assert outs == [os.path.join(build_dir, name)] * 2
    assert os.listdir(build_dir) == [name]
    import ctypes
    assert ctypes.CDLL(outs[0]).f5i_available() == 0
