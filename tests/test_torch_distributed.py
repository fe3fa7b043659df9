"""Several ranks (``poreplex_torch/parallel/distributed.py``) on the CPU.

Read ownership, the file-list split and the count matrices equal
poreplex-tpu's exactly. Two gloo ranks run ``commandline.main`` over the
fixture of tests/test_distributed_multiprocess.py (two multi-read FAST5
files of 16 reads): their manifests are disjoint and together hold every
read, and rank 0's merged counts equal a one-rank run's and poreplex-tpu's
single-host session's.
"""

import json
import logging
import os
import socket
import subprocess
import sys
from collections import defaultdict

import numpy as np
import pytest

from poreplex_tpu.io.writers import \
    FinalSummaryTracker as JaxFinalSummaryTracker
from poreplex_tpu.parallel import distributed as jdist
from poreplex_torch.io.writers import FinalSummaryTracker
from poreplex_torch.parallel import distributed

from test_distributed_multiprocess import _make_session_fixtures
from test_torch_commandline import reduced_presets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each rank's own bound on its run: a rank that hangs fails its test
RANK_TIMEOUT = 120

ENTRIES = [('dir/f{}.fast5'.format(i % 7), 'read-{}'.format(i))
           for i in range(200)]


@pytest.mark.parametrize('size', [1, 2, 3, 4])
def test_owns_entry_matches_jax(size):
    for rank in range(size):
        got = [distributed.owns_entry(e, rank, size) for e in ENTRIES]
        assert got == [jdist.owns_entry(e, rank, size) for e in ENTRIES]
    owners = [sum(distributed.owns_entry(e, r, size) for r in range(size))
              for e in ENTRIES]
    assert owners == [1] * len(ENTRIES)


@pytest.mark.parametrize('size', [1, 2, 3, 4])
def test_shard_file_list_matches_jax(size):
    parts = [distributed.shard_file_list(ENTRIES, rank, size)
             for rank in range(size)]
    assert parts == [jdist.shard_file_list(ENTRIES, rank, size)
                     for rank in range(size)]
    assert sorted(e for part in parts for e in part) == sorted(ENTRIES)


def feed(tracker, size, rank):
    """Rank ``rank``'s share of 200 result dicts of every label, status
    and barcode, an unknown status and label among them."""
    labels = ('pass', 'fail', 'artifact', None)
    statuses = jdist.STATUS_VOCAB + ('a_new_status',)
    results = []
    for i, entry in enumerate(ENTRIES):
        if not distributed.owns_entry(entry, rank, size):
            continue
        result = {'status': statuses[i % len(statuses)]}
        if labels[i % 4] is not None:
            result['label'] = labels[i % 4]
        if i % 5 < 4:
            result['barcode'] = i % 5
        results.append(result)
    tracker.feed_results(results)
    return tracker


def trackers(size, rank):
    label_names = {'pass': 'pass', 'fail': 'fail', 'artifact': 'artifact'}
    barcode_names = {None: 'undetermined', 0: 'BC1', 1: 'BC2', 2: 'BC3',
                     3: 'BC4'}
    return (feed(FinalSummaryTracker(label_names, barcode_names), size, rank),
            feed(JaxFinalSummaryTracker(label_names, barcode_names), size,
                 rank))


@pytest.mark.parametrize('size', [1, 2, 3, 4])
def test_count_matrices_match_jax(size):
    total = 0
    for rank in range(size):
        tracker, jtracker = trackers(size, rank)
        mat = distributed.counts_to_matrix(tracker)
        assert mat.dtype == np.int64
        np.testing.assert_array_equal(mat, jdist.counts_to_matrix(jtracker))
        assert distributed.matrix_to_counts(mat, tracker) == \
            jdist.matrix_to_counts(mat, jtracker)
        total = total + mat
    merged = distributed.matrix_to_counts(total, trackers(1, 0)[0])
    assert merged == distributed.matrix_to_counts(
        distributed.counts_to_matrix(trackers(1, 0)[0]), trackers(1, 0)[0])
    assert sum(merged.values()) == len(ENTRIES)


def test_one_process_is_the_identity():
    tracker = trackers(1, 0)[0]
    assert distributed.process_info() == (0, 1)
    assert distributed.merge_final_counts(tracker) == dict(tracker.counts)
    counts = np.arange(12, dtype=np.int64).reshape(3, 4)
    np.testing.assert_array_equal(distributed.allreduce_counts(counts),
                                  counts)
    assert distributed.initialize_from_config({'num_nodes': 1}) is False


@pytest.mark.parametrize('config,message', [
    ({'num_nodes': 2, 'node_rank': 0}, 'coordinator'),
    ({'num_nodes': 2, 'coordinator': '127.0.0.1:1'}, 'node-rank'),
    ({'num_nodes': 2, 'node_rank': 2, 'coordinator': '127.0.0.1:1'},
     'node-rank'),
])
def test_incomplete_rank_options_raise(config, message):
    with pytest.raises(ValueError, match=message):
        distributed.initialize_from_config(config)


# --------------------------------------------------------- two gloo ranks

# one rank: commandline.main over argv, then a JSON of its manifest and,
# on rank 0, the merged counts its printer holds
RANK = '''
import json, os, sys
from poreplex_torch import commandline
argv, out = json.loads(sys.argv[1]), sys.argv[2]
printer = commandline.main(commandline.parse_args(argv))
counts = None if printer is None else sorted(
    [list(map(str, key)), value]
    for key, value in printer.__self__.counts.items())
with open(os.path.join(argv[3], '.processed-reads')) as f:
    manifest = sorted(line.rstrip('\\n').split('\\t') for line in f)
with open(out, 'w') as f:
    json.dump({'counts': counts, 'manifest': manifest}, f)
'''


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(base, indir, preset, size):
    """``size`` rank processes of the CLI over ``indir``; their JSONs by
    rank."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, outs = [], []
    for rank in range(size):
        argv = ['-i', indir, '-o', str(base / 'rank{}'.format(rank)), '-c',
                preset, '--cpu', '-y', '-q', '--barcoding', '--polya',
                '--filter-chimera', '--device-batch-size', '8',
                '--num-nodes', str(size), '--node-rank', str(rank),
                '--coordinator', '127.0.0.1:{}'.format(port)]
        outs.append(str(base / 'rank{}.json'.format(rank)))
        procs.append(subprocess.Popen(
            [sys.executable, '-c', RANK, json.dumps(argv), outs[-1]],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, stderr.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def jax_session_counts(indir, outdir, preset):
    """poreplex-tpu's single-host session over ``indir``, its counts as
    RANK writes them."""
    from poreplex_tpu.config import build_config as jax_build_config
    from poreplex_tpu.pipeline.session import ProcessingSession
    config = jax_build_config(indir, outdir, preset, barcoding=True,
                              measure_polya=True, filter_unsplit_reads=True,
                              quiet=True, device_batch_size=8)
    logger = logging.getLogger('test-torch-distributed-jax')
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    printer = ProcessingSession.run(config, logger)
    assert printer is not None
    return sorted([list(map(str, key)), value]
                  for key, value in printer.__self__.counts.items())


@pytest.fixture(scope='module')
def rank_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('ranks')
    indir = str(base / 'fast5')
    os.makedirs(indir)
    n_reads = _make_session_fixtures(indir)
    jax_preset, torch_preset = reduced_presets(base)
    two = run_ranks(base / 'two', indir, torch_preset, 2)
    one = run_ranks(base / 'one', indir, torch_preset, 1)
    jax_counts = jax_session_counts(indir, str(base / 'jax'), jax_preset)
    return n_reads, two, one, jax_counts


def test_ranks_own_disjoint_reads(rank_runs):
    n_reads, two, one, _ = rank_runs
    manifests = [set(map(tuple, r['manifest'])) for r in two]
    assert manifests[0] and manifests[1]
    assert not manifests[0] & manifests[1]
    assert manifests[0] | manifests[1] == set(map(tuple, one[0]['manifest']))
    owners = defaultdict(set)
    for rank, manifest in enumerate(manifests):
        for entry in manifest:
            owners[rank].add(distributed.owns_entry(entry, rank, 2))
    assert owners == {0: {True}, 1: {True}}


def test_merged_counts_equal_one_rank_and_jax(rank_runs):
    n_reads, two, one, jax_counts = rank_runs
    assert two[1]['counts'] is None
    assert two[0]['counts'] == one[0]['counts'] == jax_counts
    assert sum(value for _, value in two[0]['counts']) == n_reads
