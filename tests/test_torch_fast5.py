"""The port's simulator, FAST5 writer and FAST5 reader agree with each
other and with the JAX package's reader, and a read loaded from memory
(``simulate.MemoryRead``, what chip_smoke.py drives) reaches stage 1
exactly as the same read loaded from its FAST5 file."""

import numpy as np
import pytest

from poreplex_tpu import fast5 as jfast5
from poreplex_torch import fast5, simulate
from poreplex_torch.config import build_config
from poreplex_torch.pipeline.analyzer import (EVENT_COLUMNS, BatchAnalyzer,
                                              pool_signal)
from poreplex_torch.pipeline.read import ReadRecord

METADATA = ('duration', 'start_time', 'channel_number', 'sampling_rate',
            'run_id', 'sample_id', 'offset', 'pa_scale')
SCALARS = ('sequence', 'qstring', 'block_stride', 'sequence_length',
           'mean_qscore', 'num_events', 'first_sample_template')


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    indir = str(tmp_path_factory.mktemp('fast5-in'))
    entries = simulate.make_fixture_dir(indir, n_reads=3, seed=9,
                                        transcript_len=4000, barcode=1)
    rng = np.random.default_rng(9)
    reads = [simulate.simulate_read(rng, transcript_len=4000, barcode=1)
             for _ in range(3)]
    return indir, entries, reads


def test_fixture_ids_follow_the_seed(fixture):
    _, entries, reads = fixture
    assert [read_id for _, read_id in entries] == [r.read_id for r in reads]
    assert fast5.get_read_ids(entries[0][0], fixture[0]) == [entries[0]]


@pytest.mark.parametrize('reader', ['port', 'jax'])
def test_file_matches_memory_read(fixture, reader):
    indir, entries, reads = fixture
    opener = fast5.Fast5Reader if reader == 'port' else jfast5.Fast5Reader
    for (fname, read_id), read in zip(entries, reads):
        mem = simulate.MemoryRead(read)
        with opener('{}/{}'.format(indir, fname), read_id) as f5:
            for name in METADATA:
                assert getattr(f5, name) == getattr(mem, name), name
            np.testing.assert_array_equal(f5.get_raw_dac(),
                                          mem.get_raw_dac())
            got = f5.get_basecall(columns=EVENT_COLUMNS)
        ref = mem.get_basecall(columns=EVENT_COLUMNS)
        for key in SCALARS:
            assert got[key] == ref[key], key
        for col in EVENT_COLUMNS:
            np.testing.assert_array_equal(got['events'][col],
                                          ref['events'][col])


def test_analyzer_loads_memory_and_file_alike(fixture):
    indir, entries, reads = fixture
    config = build_config(indir, indir, device='cpu', device_batch_size=4)
    analyzer = BatchAnalyzer(config)
    results, from_files = analyzer.load_batch(entries)
    assert results == []
    from_memory = []
    for read in reads:
        analyzer.add_read(ReadRecord('memory.fast5', indir, read.read_id),
                          simulate.MemoryRead(read), results, from_memory)
    assert results == []
    for a, b in zip(from_files, from_memory):
        np.testing.assert_array_equal(a.pooled, b.pooled)
        assert a.head_len == b.head_len
        assert (a.channel, a.duration, a.start_time_s, a.run_id) == \
            (b.channel, b.duration, b.start_time_s, b.run_id)
    np.testing.assert_array_equal(
        from_memory[0].pooled,
        pool_signal(reads[0].raw_dac, analyzer.stride,
                    simulate.RANGE / simulate.DIGITISATION, simulate.OFFSET))
