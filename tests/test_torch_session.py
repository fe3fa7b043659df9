"""A poreplex_torch session (on the CPU) and a poreplex_tpu session on the
same fixture, built with the recipe of tests/test_golden_session.py, write
byte-identical files (the sequencing summary, the FASTQ streams and the
processed-reads manifest): with barcoding and adapter trimming on, and
again with poly(A) and the unsplit filter on as well, where the torch
session's canonical outputs also equal tests/golden/session_golden.json."""

import gzip
import json
import logging
import os

import pytest

from poreplex_tpu import simulate
from test_golden_session import GOLDEN_PATH, _canonical_outputs


def output_files(outputdir):
    """{relative path: bytes} of every file a session wrote."""
    files = {}
    for root, _, names in os.walk(outputdir):
        for name in names:
            path = os.path.join(root, name)
            with open(path, 'rb') as f:
                files[os.path.relpath(path, outputdir)] = f.read()
    return files


def reduce_shapes(config):
    config['segmentation']['segmentation_scan_limit'] = 22500
    config['signal_processing']['scaler_input_length'] = 3000


def run_both(tmp_path_factory, **options):
    """(torch outputs, JAX outputs, (torch printer, JAX printer), torch
    output directory) of one fixture run by both packages."""
    from poreplex_tpu.config import build_config as jax_build_config
    from poreplex_tpu.pipeline.session import \
        ProcessingSession as JaxSession
    from poreplex_torch.config import build_config
    from poreplex_torch.pipeline.session import ProcessingSession

    indir = tmp_path_factory.mktemp('session-in')
    simulate.make_fixture_dir(str(indir), n_reads=6, seed=20,
                              polya_len=2400)
    simulate.make_fixture_dir(str(indir / 'nested'), n_reads=3, seed=21,
                              multi_read=True, basecall='guppy')
    options.update(device_batch_size=8, barcoding=True, trim_adapter=True,
                   quiet=True)

    jax_out = str(tmp_path_factory.mktemp('session-jax'))
    jconfig = jax_build_config(str(indir), jax_out, **options)
    reduce_shapes(jconfig)
    jax_printer = JaxSession.run(jconfig, logging.getLogger('test-jax'))
    assert jax_printer is not None

    torch_out = str(tmp_path_factory.mktemp('session-torch'))
    config = build_config(str(indir), torch_out, device='cpu', **options)
    reduce_shapes(config)
    printer = ProcessingSession.run(config, logging.getLogger('test-torch'))
    assert printer is not None
    return (output_files(torch_out), output_files(jax_out),
            (printer, jax_printer), torch_out)


@pytest.fixture(scope='module')
def both_sessions(tmp_path_factory):
    return run_both(tmp_path_factory)[:3]


@pytest.fixture(scope='module')
def full_sessions(tmp_path_factory):
    """The golden recipe: poly(A) and the unsplit filter on."""
    return run_both(tmp_path_factory, measure_polya=True,
                    filter_unsplit_reads=True)


def test_sequencing_summary_identical(both_sessions):
    got, ref, _ = both_sessions
    summary = got['sequencing_summary.txt']
    assert len(summary.decode().splitlines()) == 10
    assert summary == ref['sequencing_summary.txt']


def test_fastq_identical(both_sessions):
    got, ref, _ = both_sessions
    fastq = sorted(p for p in got if p.startswith('fastq' + os.sep))
    assert fastq == sorted(p for p in ref if p.startswith('fastq' + os.sep))
    records = sum(len(gzip.decompress(got[p]).splitlines()) // 4
                  for p in fastq)
    assert records == 9
    for path in fastq:
        assert got[path] == ref[path], path
    assert set(got) == set(ref)
    assert got['.processed-reads'] == ref['.processed-reads']


def test_final_summary_prints(both_sessions, tmp_path):
    """The end-of-run count matrix prints as the JAX session's does."""
    _, _, printers = both_sessions
    texts = []
    for i, printer in enumerate(printers):
        path = tmp_path / 'summary{}.txt'.format(i)
        with open(path, 'w') as f:
            printer(f)
        texts.append(path.read_text())
    assert texts[0].startswith('==== Result Summary ====')
    assert 'Successfully processed' in texts[0]
    assert texts[0] == texts[1]


def test_polya_unsplit_outputs_identical(full_sessions):
    got, ref, _, _ = full_sessions
    summary = got['sequencing_summary.txt'].decode().splitlines()
    assert summary[0].endswith('\tpolya_dwell')
    assert len(summary) == 10
    assert all(row.split('\t')[-1] for row in summary[1:])
    assert set(got) == set(ref)
    for path in got:
        assert got[path] == ref[path], path


def test_polya_unsplit_outputs_match_golden(full_sessions):
    _, _, _, outdir = full_sessions
    golden = json.loads(GOLDEN_PATH.read_text())
    outputs = _canonical_outputs(outdir)
    assert outputs['summary'] == golden['summary']
    assert outputs['fastq'] == golden['fastq']
