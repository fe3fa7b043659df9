"""A preset of other widths and HMM shapes than the shipped one
(``poreplex_torch.simulate.write_widened_preset``: the scaler's LSTMs at
96 units, the demultiplexer's BiLSTM(56) and LSTM(128), a 7-state
segmentation HMM with 3 mixture components and an 8-state unsplit HMM with
4), run by a poreplex_torch session on the CPU from its JSON form and by a
poreplex_tpu session from its YAML form over the fixture of
tests/test_torch_session.py, with barcoding, adapter trimming, poly(A)
and the unsplit filter on: the two write the same files, byte for byte.
The widened networks compute the shipped ones' functions (their new
units feed no old unit), within 1e-5."""

import json
import logging

import numpy as np
import pytest
import torch

from poreplex_tpu import simulate as jax_simulate
from poreplex_torch import simulate
from poreplex_torch.config import load_preset
from poreplex_torch.models.demux import DemuxModel
from poreplex_torch.models.scaler import ScalerModel
from poreplex_torch.models.segmentation import SegmentationHMM
from test_torch_session import output_files, reduce_shapes

OPTIONS = dict(device_batch_size=8, barcoding=True, trim_adapter=True,
               measure_polya=True, filter_unsplit_reads=True, quiet=True)


@pytest.fixture(scope='module')
def preset(tmp_path_factory):
    return simulate.write_widened_preset(
        str(tmp_path_factory.mktemp('widened')), seed=7)


@pytest.fixture(scope='module')
def sessions(tmp_path_factory, preset):
    """(torch outputs, JAX outputs) of the fixture on the widened preset."""
    from poreplex_tpu.config import build_config as jax_build_config
    from poreplex_tpu.pipeline.session import \
        ProcessingSession as JaxSession
    from poreplex_torch.config import build_config
    from poreplex_torch.pipeline.session import ProcessingSession

    indir = tmp_path_factory.mktemp('widened-in')
    jax_simulate.make_fixture_dir(str(indir), n_reads=6, seed=20,
                                  polya_len=2400)
    jax_simulate.make_fixture_dir(str(indir / 'nested'), n_reads=3, seed=21,
                                  multi_read=True, basecall='guppy')

    jax_out = str(tmp_path_factory.mktemp('widened-jax'))
    jconfig = jax_build_config(str(indir), jax_out,
                               preset=simulate.preset_yaml(preset), **OPTIONS)
    reduce_shapes(jconfig)
    assert JaxSession.run(jconfig, logging.getLogger('test-jax')) is not None

    torch_out = str(tmp_path_factory.mktemp('widened-torch'))
    config = build_config(str(indir), torch_out, preset=preset, device='cpu',
                          **OPTIONS)
    reduce_shapes(config)
    assert ProcessingSession.run(config,
                                 logging.getLogger('test-torch')) is not None
    return output_files(torch_out), output_files(jax_out)


def test_widened_shapes(preset):
    config = load_preset(preset)
    scaler = np.load(config['signal_processing']['scaler_model'])
    demux = np.load(config['demultiplexing']['demux_model'])
    assert scaler['lstm1/recurrent'].shape == (96, 384)
    assert scaler['lstm2/kernel'].shape == (96, 384)
    assert scaler['dense/kernel'].shape == (96, 2)
    assert demux['bilstm_fwd/recurrent'].shape == (56, 224)
    assert demux['lstm2/kernel'].shape == (112, 512)
    assert demux['lstm2/recurrent'].shape == (128, 512)
    seg = SegmentationHMM(config['segmentation_model'], device='cpu')
    uns = SegmentationHMM(config['unsplit_read_detection_model'],
                          device='cpu')
    assert tuple(seg.mus.shape) == (7, 3)
    assert tuple(uns.mus.shape) == (8, 4)
    for hmm in (seg, uns):
        assert {'adapter', 'polya-tail', 'leader-low', 'leader-high',
                'leader-mid'} <= set(hmm.state_names)
    assert uns.state_names[-1] == 'transcript-b'


def test_widened_networks_compute_the_shipped_ones(preset):
    shipped, widened = load_preset(), load_preset(preset)
    rng = np.random.default_rng(5)
    models = [ScalerModel(c['signal_processing']['scaler_model'],
                          input_length=3000, device='cpu')
              for c in (shipped, widened)]
    heads = torch.from_numpy(rng.normal(90, 12, (3, 200)).astype(np.float32))
    with torch.inference_mode():
        got = [m(heads)[0].numpy() for m in models]
    np.testing.assert_allclose(got[1], got[0], atol=1e-5)
    models = [DemuxModel(c['demultiplexing']['demux_model'], device='cpu')
              for c in (shipped, widened)]
    windows = torch.from_numpy(rng.normal(0, 1, (3, 300)).astype(np.float32))
    with torch.inference_mode():
        got = [m(windows).numpy() for m in models]
    np.testing.assert_allclose(got[1], got[0], atol=1e-5)


def test_widened_preset_yaml_is_the_json(preset):
    import yaml
    with open(simulate.preset_yaml(preset)) as f:
        from_yaml = yaml.safe_load(f)
    with open(preset) as f:
        assert from_yaml == json.load(f)


def test_widened_sessions_write_the_same_files(sessions):
    got, ref = sessions
    summary = got['sequencing_summary.txt'].decode().splitlines()
    assert summary[0].endswith('\tpolya_dwell')
    assert len(summary) == 10
    assert set(got) == set(ref)
    assert any(p.startswith('fastq') for p in got)
    for path in got:
        assert got[path] == ref[path], path
