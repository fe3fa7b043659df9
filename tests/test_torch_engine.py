"""poreplex_torch DeviceEngine.run_stage1_flat on the CPU vs poreplex_tpu's
at the preset's full shapes (6,666 segmentation frames, 2,000-frame scaler
head) on reads from simulate.make_fixture_dir: extents, present, qc_ok and
demux_ok exactly equal; scaling and demux probabilities within 5e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreplex_tpu import simulate
from poreplex_tpu.ops import normalize as jnormalize
from poreplex_tpu.config import build_config as jax_build_config
from poreplex_tpu.pipeline.engine import DeviceEngine as JaxEngine
from poreplex_torch.config import build_config
from poreplex_torch.fast5 import Fast5Reader
from poreplex_torch.ops import normalize
from poreplex_torch.pipeline.analyzer import pool_signal
from poreplex_torch.pipeline.engine import DeviceEngine

ATOL = 5e-5
B = 8


@pytest.fixture(scope='module', params=['exact', 'fast'])
def stage1_outputs(request, tmp_path_factory):
    """Both engines on the same reads, with the u16 ('exact') or the u8
    ('fast') wire."""
    indir = str(tmp_path_factory.mktemp('engine-in'))
    entries = simulate.make_fixture_dir(indir, n_reads=5, seed=41)
    entries += simulate.make_fixture_dir(indir + '/long', n_reads=2,
                                         seed=42, transcript_len=100000)
    options = dict(barcoding=True, device_batch_size=B,
                   wire_precision=request.param)
    engine = DeviceEngine(build_config(indir, indir, device='cpu',
                                       **options))
    jengine = JaxEngine(jax_build_config(indir, indir, **options))
    reads = []
    for i, (fname, read_id) in enumerate(entries):
        path = (indir if i < 5 else indir + '/long') + '/' + fname
        with Fast5Reader(path, read_id) as f5:
            pooled = pool_signal(f5.get_raw_dac(), engine.stride,
                                 f5.pa_scale, f5.offset)
        reads.append((pooled, min(len(pooled), engine.seg_frames),
                      min(engine.scaler.pooled_length, len(pooled))))
    wire, n = engine.pack_stage1_flat(reads)
    jwire, jn = jengine.pack_stage1_flat(reads)
    assert n == jn == len(reads)
    for a, b in zip(wire, jwire):             # the flat stream, the aux table
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got, _ = engine.run_stage1_flat(reads)
    ref, _ = jengine.run_stage1_flat(reads)
    return got, ref, engine


@pytest.mark.parametrize('key', ['first', 'last', 'present', 'qc_ok',
                                 'demux_ok', 'adapter_len'])
def test_discrete_outputs_equal(stage1_outputs, key):
    got, ref, _ = stage1_outputs
    np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize('key', ['scaling', 'demux_probs', 'logp'])
def test_continuous_outputs_close(stage1_outputs, key):
    got, ref, _ = stage1_outputs
    if key == 'logp':
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    else:
        np.testing.assert_allclose(got[key], ref[key], atol=ATOL)


def test_reads_are_segmented(stage1_outputs):
    got, _, engine = stage1_outputs
    assert got['qc_ok'].all()
    assert got['present'][:, engine.adapter_idx].all()
    # the long reads fill the whole segmentation window
    assert (got['last'].max(axis=1)[5:] == engine.seg_frames - 1).all()


def test_offset_guard(tmp_path):
    config = build_config(str(tmp_path), str(tmp_path), device='cpu',
                          device_batch_size=4096)
    with pytest.raises(ValueError, match='2\\*\\*24'):
        DeviceEngine(config)


def test_med_mad_normalize_matches_jax():
    """The demux window normalization: odd and even valid counts, a single
    valid frame, none, and a constant row (MAD at its floor)."""
    rng = np.random.RandomState(5)
    x = rng.normal(80.0, 7.0, (6, 30)).astype(np.float32)
    x[4] = 81.5
    valid = np.ones_like(x, bool)
    for row, start in ((0, 7), (1, 8), (2, 29), (3, 30)):
        valid[row, :start] = False
    got = normalize.med_mad_normalize(torch.from_numpy(x),
                                      torch.from_numpy(valid)).numpy()
    ref = np.asarray(jnormalize.med_mad_normalize(jnp.asarray(x),
                                                  jnp.asarray(valid)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-6, atol=1e-6)
