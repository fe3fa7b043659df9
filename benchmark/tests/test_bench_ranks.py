"""A cell whose configuration asks for ranks, on the CPU with two gloo
ranks, the harness's look for a card skipped: every read a rank owns is
served, completed and judged once; the listing keeps up with each rank's
own session; a configuration without ranks runs as before; and the faults
of ranks (a rank that owns every entry, a rank killed or stuck in the
window, the exchange of counts left out) read ``correct`` false within the
run's deadline. Each rank process is bounded by the harness's deadlines
(``READY_SECONDS`` to warm up, then ``seconds + grace + margin``)."""

import os
import subprocess
import sys
import threading
import time

import pytest

from benchmark import run
from benchmark.harness import ranks, traffic
from benchmark.harness.source import PacedSource, owns
from poreplex_torch.parallel import distributed

SEED = 5 ** 15
CELL = 'full.mrna.ranks4'
SMALL = dict(device='cpu', pool_reads=8, batch_size=2, judged_reads=8,
             ranks=2)


@pytest.fixture(autouse=True)
def bounded_set_up(monkeypatch):
    monkeypatch.setattr(ranks, 'READY_SECONDS', 240)


def with_prelude(monkeypatch, code):
    """Each rank runs ``code`` first (``rank`` is its index), as a planted
    fault."""
    prelude = ('import sys\n'
               'rank = int(sys.argv[sys.argv.index("--rank") + 1])\n' +
               code + '\n'
               'from benchmark.harness import ranks\n'
               'sys.exit(ranks.rank_main(sys.argv[1:]))\n')
    monkeypatch.setattr(ranks, 'rank_command',
                        lambda args: [sys.executable, '-c', prelude] + args)


@pytest.fixture(scope='module')
def sound():
    return run.run_cell(CELL, SEED, 1, grace=60, **SMALL)


def test_every_owned_read_is_completed_once(sound):
    per_rank = sound['info']['ranks']
    assert sound['correct'] is True
    assert sound['device']['count'] == 2
    # a read another rank owns would count as failed here
    assert sound['failed'] == 0
    assert sound['attempted'] == sum(r['reads'] for r in per_rank)
    assert all(r['reads'] == r['completed'] > 0 for r in per_rank)
    assert all(not r['ended_by_parent'] and r['code'] == 0
               for r in per_rank)
    checks = sound['checks']
    assert checks['judged_reads']['value'] == sound['attempted']
    assert checks['missing_rows']['value'] == 0
    assert list(sound)[-1] == 'checks'


def test_no_row_twice_and_the_merge_is_the_sum(sound):
    assert sound['checks']['duplicate_rows'] == {'value': 0, 'limit': 0}
    assert sound['checks']['merged_counts_differ'] == {'value': 0,
                                                       'limit': 0}


def test_end_to_end_metrics_over_every_rank(sound):
    assert set(sound['metrics']) == {'reads_per_s', 'setup_s'}
    window = sound['info']['window_s']
    assert sound['metrics']['reads_per_s']['value'] == pytest.approx(
        sound['attempted'] / window)
    starts = [r['window'][0] for r in sound['info']['ranks']]
    assert min(starts) == 0 and max(starts) < 1.0


def test_ownership_is_the_ports():
    for k in range(400):
        entry = (PacedSource.filename(k % 7), 'p{:04d}-r{:05d}'.format(
            k % 3, k))
        for d in (1, 2, 4):
            for rank in range(d):
                assert owns(entry[0], entry[1], rank, d) == \
                    distributed.owns_entry(entry, rank, d)


def pool(n=8):
    return traffic.make_pool(dict(traffic.load('reads.mrna'),
                                  pool_reads=n))


def test_the_ranks_serve_the_one_process_listing_between_them():
    """Every rank lists the same files; what they serve is disjoint and
    together what one process serves."""
    reads = pool()
    sources = [PacedSource(reads, SEED, batch_size=4, seconds=60,
                           lead=100, rank=k, ranks=3) for k in range(4)]
    sources[3] = PacedSource(reads, SEED, batch_size=4, seconds=60,
                             lead=100)
    listings = []
    for src in sources:
        src.start()
        files = src.list_files()
        listings.append([src.read_ids(next(files)) for _ in range(5)])
    assert listings[0] == listings[1] == listings[2] == listings[3]
    served = [set(src.served) for src in sources[:3]]
    assert all(served) and not any(a & b for a in served for b in served
                                   if a is not b)
    assert set.union(*served) == set(sources[3].served)
    assert sources[3].served == sources[3].index_of


def session_of(src, owner, batch_size):
    """A session that keeps the entries ``owner`` owns and opens them a
    whole batch at a time, as the port's does."""
    files, jobstack = src.list_files(), []
    open_read = src.opener()
    for relpath in files:
        for entry in src.read_ids(relpath):
            if owner(entry):
                jobstack.append(entry)
        while len(jobstack) >= batch_size:
            for entry in jobstack[:batch_size]:
                open_read(*entry)
            del jobstack[:batch_size]


@pytest.mark.parametrize('ranks_, rank', [(2, 1), (4, 3)])
def test_the_listing_keeps_up_with_a_ranks_own_session(ranks_, rank):
    """The listing stays ``lead`` batches ahead of the rank's own batches:
    paced on every entry it would wait for reads the rank never opens."""
    reads, batch, seconds = pool(64), 4, 3

    def owner(entry):
        return owns(entry[0], entry[1], rank, ranks_)
    src = PacedSource(reads, SEED, batch, seconds, rank=rank,
                      ranks=ranks_)
    src.start()
    t = time.perf_counter()
    worker = threading.Thread(target=session_of, args=(src, owner, batch))
    worker.start()
    while len(src.batches) < 40 and time.perf_counter() - t < seconds:
        time.sleep(0.01)
    assert len(src.batches) >= 40, 'the listing stalled'
    assert time.perf_counter() - t < seconds
    worker.join(timeout=seconds + 10)
    assert not worker.is_alive()
    owned = {rid for k in range(len(src.batches))
             for rid, _, mine in src.file_entries(k) if mine}
    assert set(src.served) == owned

    # one process's pacing counts every entry: it stalls here
    paced = PacedSource(reads, SEED, batch, seconds)
    paced.start()
    stalled = threading.Thread(target=session_of,
                               args=(paced, owner, batch), daemon=True)
    stalled.start()
    time.sleep(1.0)
    assert len(paced.batches) < 10
    stalled.join(timeout=seconds + 10)
    assert not stalled.is_alive()


def test_a_configuration_without_ranks_is_unchanged():
    config = run.load_json('benchmark/configs/rna-r941.full.json')
    assert 'ranks' not in config
    assert run.session_argv(config, 'IN', 'OUT', 'cuda', 'exact') == [
        '-i', 'IN', '-o', 'OUT', '-y', '-q', '--mesh-shape', '1',
        '--batch-size', '256', '--device-batch-size', '256', '-p', '1',
        '--barcoding', '--barcoding-quality-filter', '7', '--polya',
        '--filter-chimera', '--trim-adapter', '--minimum-length', '10']
    result = run.run_cell('demux.mrna', SEED, 1, device='cpu', pool_reads=8,
                          batch_size=4, judged_reads=8)
    assert list(result) == ['correct', 'attempted', 'failed', 'metrics',
                            'device', 'info', 'checks']
    assert result['correct'] is True
    assert result['device'] == {'platform': 'cpu', 'kind': 'cpu',
                                'count': 1, 'memory_peak_bytes': 0}
    assert list(result['checks']) == ['judged_reads', 'missing_rows',
                                      'rows_differ_share']
    assert 'ranks' not in result['info']


def test_a_rank_that_owns_every_entry(monkeypatch):
    with_prelude(monkeypatch, (
        'if rank == 1:\n'
        '    from poreplex_torch.parallel import distributed\n'
        '    distributed.owns_entry = lambda *a: True'))
    result = run.run_cell(CELL, SEED, 1, grace=60, **SMALL)
    assert result['correct'] is False
    assert result['checks']['duplicate_rows']['value'] > 0


def test_the_exchange_of_counts_left_out(monkeypatch):
    with_prelude(monkeypatch, (
        'from poreplex_torch.parallel import distributed\n'
        'import numpy as np\n'
        'distributed.allreduce_counts = lambda m: np.asarray(m)'))
    result = run.run_cell(CELL, SEED, 1, grace=60, **SMALL)
    assert result['correct'] is False
    assert result['checks']['merged_counts_differ']['value'] > 0
    assert result['checks']['duplicate_rows']['value'] == 0


FAULT_AT_SECOND_BATCH = (
    'if rank == 1:\n'
    '    import os, signal, time\n'
    '    from poreplex_torch.pipeline import analyzer\n'
    '    process = analyzer.BatchAnalyzer.process_batch\n'
    '    calls = []\n'
    '    def faulty(self, *a, **k):\n'
    '        calls.append(1)\n'
    '        if len(calls) == 2:  # the warm-up took the first\n'
    '            {}\n'
    '        return process(self, *a, **k)\n'
    '    analyzer.BatchAnalyzer.process_batch = faulty')


@pytest.mark.parametrize('fault, grace, margin', [
    ('os.kill(os.getpid(), signal.SIGKILL)', 60, 10),
    ('time.sleep(3600)', 10, 5)], ids=['killed', 'stuck'])
def test_a_rank_lost_in_the_window(monkeypatch, fault, grace, margin):
    """Its reads count as failed, and the run ends within its deadline,
    ``seconds + grace + margin`` after the windows opened, instead of
    waiting in gloo for the lost rank."""
    with_prelude(monkeypatch, FAULT_AT_SECOND_BATCH.format(fault))
    t = time.perf_counter()
    result = run.run_cell(CELL, SEED, 1, grace=grace, margin=margin,
                          **SMALL)
    elapsed = time.perf_counter() - t
    lost = result['info']['ranks'][1]
    assert result['correct'] is False
    assert lost['completed'] == 0 and lost['reads'] > 0
    assert result['failed'] >= lost['reads']
    assert result['info']['deadline_s'] == 1 + grace + margin
    assert max(r['window'][1] for r in result['info']['ranks']) <= \
        result['info']['deadline_s'] + ranks.TERM_SECONDS + 1
    # set-up, the deadline and the reference, with room
    assert elapsed < result['metrics']['setup_s']['value'] + \
        result['info']['deadline_s'] + 60


def test_a_run_of_ranks_takes_two_or_more_and_a_card_each(monkeypatch):
    """One rank would merge nothing, and two ranks never share a card."""
    with pytest.raises(ValueError):
        run.run_cell(CELL, SEED, 1, device='cpu', pool_reads=8,
                     batch_size=2, judged_reads=8, ranks=1)
    with pytest.raises(ValueError):
        run.run_cell('full.mrna', SEED, 1, device='cpu', ranks=2)
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '3,1')
    assert ranks.visible_cards(2) == ['3', '1']
    with pytest.raises(ranks.NoCards):
        ranks.visible_cards(4)
    monkeypatch.delenv('CUDA_VISIBLE_DEVICES')
    assert ranks.visible_cards(4) == ['0', '1', '2', '3']


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='-1')
    out = subprocess.run(
        [sys.executable, os.path.join(run.HERE, 'run.py'), '--workload',
         CELL, '--seed', '1', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA card' in out.stderr
