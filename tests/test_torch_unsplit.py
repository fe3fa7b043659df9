"""poreplex_torch unsplit-read detection vs the JAX package: full Viterbi
paths of the unsplit HMM exactly equal to poreplex_tpu.ops.viterbi.viterbi
(logp within 1e-5 relative); the (leader_start, first, last) run trios
equal to the host walk over the same paths and to the JAX detector's,
including the overflow fallback (tests/test_unsplit_runs.py). The CUDA
kernel does not run here; chip_smoke.py holds it against the plain
version on the card."""

import jax
import numpy as np
import pytest
import torch

from poreplex_tpu.config import load_preset
from poreplex_tpu.models.segmentation import SegmentationHMM as JaxHMM
from poreplex_tpu.ops import viterbi as jvit
from poreplex_tpu.pipeline.unsplit import UnsplitReadDetector as JaxDetector
from poreplex_torch import kernels
from poreplex_torch.models.segmentation import SegmentationHMM
from poreplex_torch.ops import viterbi as vit
from poreplex_torch.pipeline.unsplit import UnsplitReadDetector, _iter_runs
from poreplex_torch.utils import union_intervals

LOGP_RTOL = 1e-5
STATE_MEANS = {0: 71.5, 1: 102.1, 2: 112.0, 3: 80.5, 4: 108.95, 5: 96.0}


@pytest.fixture(scope='module')
def preset():
    return load_preset()


@pytest.fixture(scope='module')
def model(preset):
    return SegmentationHMM(preset['unsplit_read_detection_model'],
                           device='cpu')


class FakeEvRead:
    def __init__(self, means):
        self.events = {'scaled_mean': np.asarray(means, np.float32)}
        self.sampling_rate = 3012.0


def host_runs(det, path):
    trios, leader_start = [], None
    for first, last, state in _iter_runs(path):
        if state not in det.leaderish:
            leader_start = None
            continue
        if leader_start is None:
            leader_start = first
        if state != det.adapter_idx:
            continue
        trios.append((leader_start, first, last))
        leader_start = None
    return trios


def random_jobs(seed, count):
    """Piecewise-constant state-like event means of 40 to 600 events (and
    a few past 1024, in the next event bucket)."""
    rng = np.random.RandomState(seed)
    jobs = []
    for k in range(count):
        n = rng.randint(1100, 1300) if k % 8 == 7 else rng.randint(40, 600)
        segs = []
        while sum(len(s) for s in segs) < n:
            segs.append(np.full(rng.randint(3, 60),
                                STATE_MEANS[rng.randint(0, 6)]))
        means = np.concatenate(segs)[:n] + rng.normal(0, 2.5, n)
        jobs.append((FakeEvRead(means), 0, n))
    return jobs


def test_paths_match_jax(preset, model):
    jm = JaxHMM(preset['unsplit_read_detection_model'])
    rng = np.random.RandomState(5)
    B, T = 12, 128
    x = rng.normal(95, 14, (B, T)).astype(np.float32)
    lens = rng.randint(5, T + 1, B).astype(np.int32)
    path, logp = vit.viterbi(torch.from_numpy(x), torch.from_numpy(lens),
                             *model.params())
    jpath, jlogp = jax.jit(lambda a, b: jvit.viterbi(
        a, b, jm.log_start, jm.log_trans, jm.mus, jm.sigmas, jm.logws))(
            x, lens)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp),
                               rtol=LOGP_RTOL)
    before = dict(kernels.launches)
    kpath, klogp = model.path(torch.from_numpy(x), torch.from_numpy(lens))
    assert kernels.launches == before          # CPU tensors: plain version
    assert torch.equal(kpath, path) and torch.equal(klogp, logp)


def test_runs_match_host_walk_and_jax(preset, model):
    det = UnsplitReadDetector(preset, model)
    jdet = JaxDetector(preset, JaxHMM(preset['unsplit_read_detection_model']),
                       batch_rows=8)
    jobs = random_jobs(7, 24)
    runs = det.decode_runs_batched(jobs)
    jruns = jdet.decode_runs_batched(jobs)
    paths = jdet.decode_paths_batched(jobs)
    assert sum(len(r) for r in runs) > 10
    for wruns, jwruns, path in zip(runs, jruns, paths):
        got = [tuple(map(int, r)) for r in wruns]
        assert got == host_runs(det, path)
        assert got == [tuple(map(int, r)) for r in jwruns]


def test_overflow_falls_back_to_host_walk(preset, model):
    """More adapter runs than the device table holds (K = 2 here): the
    window's run list comes from the host walk over its path, complete."""
    class TinyRuns(UnsplitReadDetector):
        MAX_RUNS = 2

    det = TinyRuns(preset, model)
    rng = np.random.RandomState(3)
    blocks = []
    for _ in range(6):                       # 6 leader -> adapter cycles
        blocks += [np.full(30, 112.0), np.full(30, 80.5),
                   np.full(30, 108.95), rng.normal(96, 8, 60)]
    means = np.concatenate(blocks)
    job = (FakeEvRead(means), 0, len(means))
    calls = []
    original = det._runs_from_path
    det._runs_from_path = lambda path: calls.append(1) or original(path)
    got = [tuple(map(int, r)) for r in det.decode_runs_batched([job])[0]]
    x = torch.from_numpy(means.astype(np.float32))[None]
    path, _ = vit.viterbi(x, torch.tensor([len(means)]), *model.params())
    expect = host_runs(det, path[0].numpy())
    assert calls and len(expect) > det.MAX_RUNS
    assert got == expect


def test_analyze_read_and_intervals(preset, model):
    """The host analysis of the JAX detector on the same trios: an event
    table with two adapter runs deep in the payload is an artifact."""
    from poreplex_tpu.utils.intervals import union_intervals as jax_union
    ivs = [[5, 9], [1, 3], [3, 4], [20, 22], [8, 12]]
    assert union_intervals(ivs) == jax_union(ivs)

    det = UnsplitReadDetector(preset, model)
    jdet = JaxDetector(preset, JaxHMM(preset['unsplit_read_detection_model']),
                       batch_rows=8)
    rng = np.random.RandomState(9)
    n = 600
    starts = np.arange(n, dtype=np.int64) * 40
    read = FakeEvRead(rng.normal(96, 10, n))
    read.events.update({
        'start': starts, 'end': starts + 40,
        'pos': np.cumsum(rng.uniform(size=n) < 0.4),
        'p_model_state': rng.uniform(0.2, 0.95, n)})
    segments = {'adapter': (0, 10)}
    payload_start, windows = det.collect_windows(read, segments, 15)
    assert (payload_start, windows) == jdet.collect_windows(read, segments,
                                                            15)
    runs = [np.zeros((0, 3), np.int64) for _ in windows]
    runs[1] = np.array([[0, 60, 140]], np.int64)
    runs[2] = np.array([[10, 20, 130]], np.int64)
    got = det.analyze_read(read, payload_start, windows, runs)
    assert got == jdet.analyze_read(read, payload_start, windows, runs)
    assert got


def test_fused_read_is_artifact_as_in_jax(tmp_path):
    """A read with a second leader and adapter inside its transcript (the
    fixture of tests/test_pipeline_e2e.py) is labelled an unsplit artifact
    by the torch analyzer on the CPU, and both reads' reports equal the
    JAX pipeline's: exactly, but for the poly(A) spikes' event means,
    within 1e-5 relative (an event mean can differ by an ulp from the
    JAX program's)."""
    import os
    from poreplex_tpu import simulate
    from poreplex_tpu.config import build_config as jax_build_config
    from poreplex_tpu.pipeline.analyzer import process_batch
    from poreplex_torch.config import build_config
    from poreplex_torch.pipeline.analyzer import BatchAnalyzer

    rng = np.random.RandomState(33)
    inp = str(tmp_path / 'in')
    os.makedirs(inp)
    normal = simulate.simulate_read(rng, transcript_len=30000)
    fused = simulate.simulate_read(rng, transcript_len=30000,
                                   extra_adapter_at=0.4, seq_per_event=0.8)
    for name, read in (('normal.fast5', normal), ('fused.fast5', fused)):
        simulate.write_single_read_fast5(os.path.join(inp, name), read)
    reads = [('normal.fast5', normal.read_id), ('fused.fast5', fused.read_id)]
    options = dict(filter_unsplit_reads=True, measure_polya=True,
                   device_batch_size=4)

    def reduce_shapes(config):
        config['segmentation']['segmentation_scan_limit'] = 22500
        config['signal_processing']['scaler_input_length'] = 3000
        return config

    got, _ = BatchAnalyzer(reduce_shapes(build_config(
        inp, str(tmp_path / 'out'), device='cpu', **options))
        ).process_batch(reads)
    ref, _ = process_batch(0, reads, reduce_shapes(jax_build_config(
        inp, str(tmp_path / 'jax-out'), **options)))
    by_file = {r['filename']: r for r in got}
    assert by_file['normal.fast5']['label'] == 'pass'
    assert by_file['fused.fast5']['status'] == 'unsplit_read'
    assert by_file['fused.fast5']['label'] == 'artifact'
    ref = {r['filename']: r for r in ref}
    assert set(by_file) == set(ref)
    for name, report in by_file.items():
        tail, ref_tail = report.pop('polya'), ref[name].pop('polya')
        assert report == ref[name]
        assert ([tail[k] for k in ('begin', 'end', 'dwell_time')] ==
                [ref_tail[k] for k in ('begin', 'end', 'dwell_time')])
        assert len(tail['spikes']) == len(ref_tail['spikes'])
        for a, b in zip(tail['spikes'], ref_tail['spikes']):
            np.testing.assert_allclose(a, b, rtol=1e-5)
