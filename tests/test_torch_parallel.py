"""The port's data parallelism in one process (``poreplex_torch/parallel/``
mesh and sharding) on a CPU mesh: mesh entries of the CPU device stand in
for cards, as the JAX tests' eight virtual CPU devices do
(tests/conftest.py), so the sharded code runs here.

The padded stage-1 wire and the sharded token-packed wire are byte-exact
against poreplex-tpu's; the sharded stage 1 over 8 entries, with a batch
that is not a multiple of 8, agrees with one device and with poreplex-tpu's
ShardedEngine (decisions exactly, scaling and demux probabilities within
ATOL, the Viterbi log-likelihood within LOGP_RTOL); a BatchAnalyzer over a mesh of 3 with poly(A) and the unsplit filter
on gives the results and written rows of the same analyzer on one device.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from poreplex_tpu.config import build_config as jax_build_config
from poreplex_tpu.parallel.mesh import make_mesh
from poreplex_tpu.parallel.sharding import ShardedEngine as JaxSharded
from poreplex_tpu.pipeline.engine import DeviceEngine as JaxEngine
from poreplex_torch import simulate
from poreplex_torch.config import build_config
from poreplex_torch.io.writers import FASTQWriter, SequencingSummaryWriter
from poreplex_torch.parallel.mesh import pad_to_multiple, select_devices
from poreplex_torch.parallel.sharding import (ShardedEngine, block_rows,
                                              shard_batch_arrays)
from poreplex_torch.pipeline.analyzer import BatchAnalyzer
from poreplex_torch.pipeline.engine import DeviceEngine
from poreplex_torch.pipeline.read import ReadRecord

from test_torch_session import reduce_shapes

ATOL = 5e-5
# the segmentation's Viterbi log-likelihood (some -400 here), relative,
# as chip_smoke.py holds the kernel's
LOGP_RTOL = 1e-5
DISCRETE = ('qc_ok', 'first', 'last', 'present', 'demux_ok', 'adapter_len')
CONTINUOUS = ('scaling', 'demux_probs')
CPU = torch.device('cpu')


def tiny_options():
    """tests/test_parallel.py's engine: barcoding, 16 rows a launch, 100
    segmentation frames."""
    return dict(barcoding=True, device_batch_size=16)


@pytest.fixture(scope='module')
def engines(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('parallel-cfg'))
    config = build_config(tmp, tmp, device='cpu', **tiny_options())
    jconfig = jax_build_config(tmp, tmp, **tiny_options())
    for c in (config, jconfig):
        c['segmentation']['segmentation_scan_limit'] = 1500
    return DeviceEngine(config), JaxEngine(jconfig)


def example_inputs(engine, batch, seed=0):
    """tests/test_parallel.py's padded batch."""
    rng = np.random.RandomState(seed)
    pooled = rng.normal(90, 12, (batch, engine.wire_frames)
                        ).astype(np.float32)
    pooled_len = np.full(batch, engine.seg_frames, np.int32)
    head_len = np.minimum(engine.scaler.pooled_length, engine.wire_frames)
    return pooled, pooled_len, np.full(batch, head_len, np.int32)


def example_reads(engine, n, seed, lengths=None):
    """(pooled, pooled_len, head_len) reads of random lengths."""
    rng = np.random.RandomState(seed)
    reads = []
    for i in range(n):
        L = (int(rng.uniform(40, engine.wire_frames)) if lengths is None
             else lengths)
        sig = rng.normal(90, 12, L).astype(np.float32)
        reads.append((sig, min(L, engine.seg_frames),
                      min(engine.scaler.pooled_length, L)))
    return reads


def assert_stage1_close(got, ref, n=None):
    for key in DISCRETE:
        np.testing.assert_array_equal(got[key][:n], ref[key][:n],
                                      err_msg=key)
    for key in CONTINUOUS:
        np.testing.assert_allclose(got[key][:n], ref[key][:n], rtol=0,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(got['logp'][:n], ref['logp'][:n],
                               rtol=LOGP_RTOL, atol=0)


# ------------------------------------------------------------------ mesh

def test_select_devices_on_the_cpu(tmp_path):
    config = build_config(str(tmp_path), str(tmp_path), device='cpu')
    assert select_devices(config) == [CPU]
    config['mesh_shape'] = 3
    assert select_devices(config) == [CPU] * 3
    config['device'] = 'cuda'
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        select_devices(config)


@pytest.mark.parametrize('n,d', [(0, 3), (1, 3), (11, 8), (16, 8), (7, 3),
                                 (1024, 4)])
def test_blocks_split_like_a_padded_batch_axis(n, d):
    """Contiguous blocks of ceil(n / d) rows: P('batch')'s split of the
    rows padded to pad_to_multiple(n, d)."""
    blocks = block_rows(n, d)
    assert len(blocks) == d
    assert [r for lo, hi in blocks for r in range(lo, hi)] == list(range(n))
    size = pad_to_multiple(n, d) // d
    for k, (lo, hi) in enumerate(blocks):
        assert lo == min(k * size, n) and hi == min((k + 1) * size, n)
    arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    parts = shard_batch_arrays([CPU] * d, arr)
    assert all(hi > lo for _, lo, hi, _ in parts)
    np.testing.assert_array_equal(
        np.concatenate([t.numpy() for *_, (t,) in parts] +
                       [np.zeros((0, 2), np.float32)]), arr)


# ------------------------------------------------------- the padded wire

@pytest.mark.parametrize('defaults', [False, True])
def test_pack_stage1_matches_jax(engines, defaults):
    engine, jengine = engines
    pooled, plen, hlen = example_inputs(engine, 11, seed=3)
    plen = plen - np.arange(11) * 7
    pooled[2, :] = -40.0 + pooled[2, :] / 10     # a negative read
    args = (pooled, plen) if defaults else (pooled, plen, hlen - 3,
                                            np.arange(11) % 3 > 0)
    got, ref = engine.pack_stage1(*args), jengine.pack_stage1(*args)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_padded_wire_equals_flat(engines):
    """poreplex-tpu's test_flat_transport_matches_padded, on the port."""
    engine = engines[0]
    reads = example_reads(engine, 7, seed=11)
    got, n = engine.run_stage1_flat(reads)
    assert n == 7
    pooled = np.zeros((7, engine.wire_frames), np.float32)
    for i, (sig, _, _) in enumerate(reads):
        pooled[i, :len(sig)] = sig
    ref = engine.run_stage1(pooled, [r[1] for r in reads],
                            [r[2] for r in reads])
    for key in DISCRETE + CONTINUOUS + ('logp',):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


# ------------------------------------------------------ the sharded wire

@pytest.fixture(scope='module')
def sharded(engines, cpu_devices):
    """{D: (port ShardedEngine, poreplex-tpu ShardedEngine)}."""
    engine, jengine = engines
    return {d: (ShardedEngine(engine, [CPU] * d),
                JaxSharded(jengine, make_mesh(cpu_devices[:d])))
            for d in (3, 8)}


@pytest.mark.parametrize('d,lengths,n_expect', [
    (8, None, 16),       # random lengths: 8 x 2 rows, every read fits
    (3, None, 18),       # 3 x 6 rows
    (3, 2000, 15),       # device 0 is full before read 15
])
def test_pack_stage1_flat_matches_jax(sharded, engines, d, lengths,
                                      n_expect):
    port, jax_sharded = sharded[d]
    reads = example_reads(engines[0], 20, seed=5, lengths=lengths)
    (flat, aux), n = port.pack_stage1_flat(reads)
    (jflat, jaux), jn = jax_sharded.pack_stage1_flat(reads)
    assert n == jn == n_expect
    assert (port.rows_per_dev, port.flat_size_dev) == \
        (jax_sharded.rows_per_dev, jax_sharded.flat_size_dev)
    for a, b in ((flat, jflat), (aux, jaux)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.fixture(scope='module')
def padded_runs(engines, sharded):
    """run_stage1 of 11 reads (not a multiple of 8) on one device, over 8
    entries, and on poreplex-tpu's 8-device ShardedEngine."""
    engine = engines[0]
    inputs = example_inputs(engine, 11, seed=3)
    port, jax_sharded = sharded[8]
    return (port.run_stage1(*inputs), engine.run_stage1(*inputs),
            jax_sharded.run_stage1(*inputs))


@pytest.mark.parametrize('against', ['one device', 'jax'])
def test_sharded_run_stage1(padded_runs, against):
    got, one, jax_out = padded_runs
    assert got['scaling'].shape == (11, 2)
    assert_stage1_close(got, one if against == 'one device' else jax_out)


@pytest.fixture(scope='module')
def flat_runs(engines, sharded):
    """run_stage1_flat of 11 reads of random lengths, as flat_runs."""
    engine = engines[0]
    reads = example_reads(engine, 11, seed=23)
    port, jax_sharded = sharded[8]
    got, n = port.run_stage1_flat(reads)
    one, n_one = engine.run_stage1_flat(reads)
    wire, jn = jax_sharded.pack_stage1_flat(reads)
    jax_out = jax_sharded.collect_stage1_flat(
        jax_sharded.dispatch_stage1_flat(wire))
    assert n == n_one == jn == 11
    return got, one, {k: v[:jn] for k, v in jax_out.items()}


@pytest.mark.parametrize('against', ['one device', 'jax'])
def test_sharded_run_stage1_flat(flat_runs, against):
    got, one, jax_out = flat_runs
    assert got['scaling'].shape == (11, 2)
    assert_stage1_close(got, one if against == 'one device' else jax_out)


def test_replicas_share_one_engine_per_device(engines):
    engine = engines[0]
    mesh = ShardedEngine(engine, [CPU] * 4)
    assert list(mesh.replicas) == [CPU]
    assert mesh.replicas[CPU] is engine


def test_sharded_warmup(sharded):
    sharded[3][0].warmup()


# --------------------------------------------------------- the analyzer

N_READS = 9


def mesh_reads():
    """Reads with poly(A) tails of two window buckets, barcodes, and two
    reads of two molecules for the unsplit filter."""
    rng = np.random.default_rng(77)
    return [simulate.simulate_read(
        rng, transcript_len=int(rng.integers(6000, 12000)),
        polya_len=int(rng.choice([1500, 9000])), barcode=i % 4,
        **(dict(extra_adapter_at=0.4, seq_per_event=0.8) if i in (2, 7)
           else {}))
        for i in range(N_READS)]


def analyze(tmp_path, devices, reads):
    """(report dicts, stage-1 outputs, summary rows, FASTQ records) of one
    batch through a BatchAnalyzer on ``devices``."""
    outdir = str(tmp_path)
    config = build_config(outdir, outdir, device='cpu', barcoding=True,
                          barcoding_quality_filter=7, trim_adapter=True,
                          measure_polya=True, filter_unsplit_reads=True,
                          device_batch_size=4)
    reduce_shapes(config)
    analyzer = BatchAnalyzer(config, devices=devices)
    results, records = [], []
    for read in reads:
        rec = ReadRecord('simulated.fast5', outdir, read.read_id)
        analyzer.add_read(rec, simulate.MemoryRead(read), results, records)
    stage1 = {}
    run_stage1 = analyzer.run_stage1

    def keep(recs):
        stage1.update(run_stage1(recs))
        return stage1
    analyzer.run_stage1 = keep
    results, _ = analyzer.process_batch(None, (results, records))
    summary = SequencingSummaryWriter(config, outdir, config['label_names'],
                                      config['barcode_names'])
    fastq = FASTQWriter(outdir, config['output_layout'])
    try:
        fastq.write_sequences(results)
        summary.write_results(results)
    finally:
        fastq.close()
        summary.close()
    with open(os.path.join(outdir, 'sequencing_summary.txt')) as f:
        rows = f.read()
    records = {}
    for root, _, files in os.walk(os.path.join(outdir, 'fastq')):
        for name in files:
            with gzip.open(os.path.join(root, name), 'rt') as f:
                records[os.path.relpath(os.path.join(root, name),
                                        outdir)] = f.read()
    return results, stage1, rows, records, analyzer


@pytest.fixture(scope='module')
def mesh_runs(tmp_path_factory):
    reads = mesh_reads()
    return {d: analyze(tmp_path_factory.mktemp('mesh{}'.format(d)),
                       [CPU] * d, reads)
            for d in (1, 3)}


def assert_same(a, b, where):
    """Equal, floats within ATOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= ATOL, where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], '{}.{}'.format(where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, '{}[{}]'.format(where, i))
    else:
        assert a == b, where


def test_mesh_analyzer_shards(mesh_runs):
    analyzer = mesh_runs[3][4]
    assert isinstance(analyzer.stage1, ShardedEngine)
    assert analyzer.polya_analyzer.devices == [CPU] * 3
    assert analyzer.unsplit_detector.devices == [CPU] * 3
    assert mesh_runs[1][4].stage1 is mesh_runs[1][4].engine


def test_mesh_results_equal_one_device(mesh_runs):
    got, ref = mesh_runs[3][0], mesh_runs[1][0]
    assert [r['read_id'] for r in got] == [r['read_id'] for r in ref]
    for a, b in zip(got, ref):
        assert_same(a, b, a['read_id'])
    # the paths the mesh must carry were taken
    assert sum('polya' in r for r in ref) >= 4
    assert any(r['status'] == 'unsplit_read' for r in ref)
    assert any(r.get('barcode') is not None for r in ref)


def test_mesh_stage1_equals_one_device(mesh_runs):
    assert_stage1_close(mesh_runs[3][1], mesh_runs[1][1])


def test_mesh_written_rows_equal_one_device(mesh_runs):
    assert mesh_runs[3][2] == mesh_runs[1][2]
    assert mesh_runs[3][3] == mesh_runs[1][3]
    assert mesh_runs[1][2].count('\n') == N_READS + 1
