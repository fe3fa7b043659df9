"""A poreplex_torch session (on the CPU) and a poreplex_tpu session on the
same fixture, built with the recipe of tests/test_golden_session.py, with
barcoding and adapter trimming on and poly(A) and the unsplit filter off,
write byte-identical sequencing summaries and FASTQ files."""

import gzip
import logging
import os

import pytest

from poreplex_tpu import simulate

# the JAX session's resume journal; resume belongs to a later slice
NOT_PORTED = {'.processed-reads'}


def output_files(outputdir):
    """{relative path: bytes} of every file a session wrote."""
    files = {}
    for root, _, names in os.walk(outputdir):
        for name in names:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, outputdir)
            if rel not in NOT_PORTED:
                with open(path, 'rb') as f:
                    files[rel] = f.read()
    return files


def reduce_shapes(config):
    config['segmentation']['segmentation_scan_limit'] = 22500
    config['signal_processing']['scaler_input_length'] = 3000


@pytest.fixture(scope='module')
def both_sessions(tmp_path_factory):
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
    options = dict(device_batch_size=8, barcoding=True, trim_adapter=True,
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
            (printer, jax_printer))


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
