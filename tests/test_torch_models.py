"""poreplex_torch models built through weights.py from the JAX models'
numpy parameters agree with the JAX models (scaling and probabilities
within 5e-5, QC, labels and Viterbi decodes exact), and the port's copies
of the preset and model assets equal the JAX package's."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch
import yaml

from poreplex_tpu.config import PRESETS_DIR as JAX_PRESETS, load_preset
from poreplex_tpu.models.demux import DemuxModel as JaxDemux
from poreplex_tpu.models.scaler import ScalerModel as JaxScaler
from poreplex_tpu.models.segmentation import SegmentationHMM as JaxHMM
from poreplex_torch import weights
from poreplex_torch.config import PRESETS_DIR, build_config
from poreplex_torch.models.demux import DemuxModel
from poreplex_torch.models.scaler import ScalerModel
from poreplex_torch.models.segmentation import SegmentationHMM

ATOL = 5e-5


def flat_numpy(params):
    """JAX model params {layer: {key: array}} -> {'layer/key': ndarray}."""
    return {'{}/{}'.format(layer, key): np.asarray(value)
            for layer, keys in params.items() for key, value in keys.items()}


def test_scaler_from_jax_params(scaler_model_path):
    jm = JaxScaler(scaler_model_path)
    m = ScalerModel(scaler_model_path, device='cpu')
    m.load_state_dict(weights.scaler_state_dict(flat_numpy(jm.params)),
                      strict=False)
    rng = np.random.RandomState(0)
    x = rng.normal(90, 12, (4, 400)).astype(np.float32)
    x[:, :100] = 0.0                       # left padding of a short head
    scaling, qc = m.predict(x)
    jscaling, jqc = jm.predict(x)
    np.testing.assert_allclose(scaling, jscaling, atol=ATOL)
    np.testing.assert_array_equal(qc, jqc)
    np.testing.assert_allclose(m.qc_scale_range, jm.qc_scale_range)
    np.testing.assert_allclose(m.qc_shift_range, jm.qc_shift_range)
    assert (m.input_length, m.input_stride, m.min_length,
            m.pooled_length) == (jm.input_length, jm.input_stride,
                                 jm.min_length, jm.pooled_length)


def test_demux_from_jax_params(demux_model_path):
    jm = JaxDemux(demux_model_path)
    m = DemuxModel(demux_model_path, device='cpu')
    m.load_state_dict(weights.demux_state_dict(flat_numpy(jm.params)))
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (6, 300)).astype(np.float32)
    x[0, :120] = -1000.0                   # left-padded short adapter
    labels, scores = m.predict(x)
    jlabels, jscores = jm.predict(x)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(scores, jscores, atol=ATOL)
    for q in (0, 7, 18):
        assert m.score_threshold(q) == jm.score_threshold(q)
    for s in (-1.0, 0.0, 0.5, float(m.calibration_table[10]), 1.0):
        assert (m.lookup_calibrated_phred_score(s) ==
                jm.lookup_calibrated_phred_score(s))


def test_hmm_from_jax_arrays_decodes_alike():
    spec = load_preset()['segmentation_model']
    jm = JaxHMM(spec)
    m = SegmentationHMM(spec, device='cpu')
    state = weights.hmm_state_dict({k: np.asarray(getattr(jm, k))
                                    for k in weights.HMM_KEYS})
    for key, value in m.state_dict().items():
        torch.testing.assert_close(value, state[key], rtol=0, atol=0)
    assert m.state_names == jm.state_names

    rng = np.random.RandomState(3)
    layout = [(71.5, 3.7, 25), (102.1, 3.9, 15), (112.0, 4.8, 12),
              (80.5, 7.4, 130), (108.95, 2.5, 60), (96.0, 11.0, 150)]
    sig = np.concatenate([rng.normal(mu, sd, n) for mu, sd, n in layout])
    x = np.zeros((2, 420), np.float32)
    x[0, :len(sig)] = sig
    x[1, :300] = sig[:300]
    lens = np.array([len(sig), 300])
    got = m.decode(x, lens)
    ref = jm.decode(x, lens)
    for name, a, b in zip(('path', 'logp', 'first', 'last', 'present'),
                          got, ref):
        if name == 'logp':
            np.testing.assert_allclose(a, b, rtol=1e-5)
        elif name == 'path':
            for i, L in enumerate(lens):
                np.testing.assert_array_equal(a[i, :L], b[i, :L])
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (m.segments_dict(got[2][0], got[3][0], got[4][0]) ==
            jm.segments_dict(ref[2][0], ref[3][0], ref[4][0]))


def test_json_preset_equals_yaml_preset():
    with open(os.path.join(JAX_PRESETS, 'rna-r941.yaml')) as f:
        expected = yaml.safe_load(f)
    with open(os.path.join(PRESETS_DIR, 'rna-r941.json')) as f:
        assert json.load(f) == expected


@pytest.mark.parametrize('relpath', [
    'MIN106-RNA001/scaler-r3.npz',
    'MIN106-RNA001/demux-tetra-r4.npz',
    'kmer_models/r9.4_180mv_70bps_5mer_RNA/template_median69pA.model',
])
def test_assets_are_byte_identical(relpath):
    assert filecmp.cmp(os.path.join(PRESETS_DIR, relpath),
                       os.path.join(JAX_PRESETS, relpath), shallow=False)


def test_config_resolves_assets_and_layout(tmp_path):
    config = build_config(str(tmp_path), str(tmp_path), barcoding=True,
                          device='cpu')
    jconfig = load_preset()
    for section, key in (('signal_processing', 'scaler_model'),
                         ('demultiplexing', 'demux_model')):
        assert os.path.isfile(config[section][key])
        assert (os.path.basename(config[section][key]) ==
                os.path.basename(jconfig[section][key]))
    assert config['output_layout'][('pass', 0)] == os.path.join('pass', 'BC1')
    assert config['output_layout'][('fail', None)] == os.path.join(
        'fail', 'undetermined')
