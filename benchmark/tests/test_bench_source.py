"""The paced source: every pool read served under fresh ids, the
listing paced on the reads the session opened and ended at the
deadline; and a whole run's session on the CPU."""

import threading
import time

import pytest

from benchmark import run
from benchmark.harness import traffic
from benchmark.harness.source import PacedSource
from poreplex_torch.pipeline import read

SEED = 3 ** 20


def pool(n=8):
    return traffic.make_pool(dict(traffic.load('reads.mrna'),
                                  pool_reads=n))


def test_listing_is_paced_and_ends_at_the_deadline():
    reads = pool()
    src = PacedSource(reads, SEED, batch_size=2, seconds=3, lead=1)
    src.start()
    files = src.list_files()
    first = src.read_ids(next(files))
    second = src.read_ids(next(files))
    assert len(first) == len(second) == 2
    third = []
    waiter = threading.Thread(target=lambda: third.extend(
        src.read_ids(next(files))))
    waiter.start()
    time.sleep(0.3)
    assert waiter.is_alive(), 'file 2 was listed before batch 0 opened'
    open_read = src.opener()
    for filename, read_id in first:
        assert open_read(filename, read_id).read_id == read_id
    waiter.join(timeout=10)
    assert not waiter.is_alive() and len(third) == 2
    # nothing more is opened: the next file waits for the deadline, and
    # then the listing ends
    assert src.read_ids(next(files)) == []
    assert time.perf_counter() >= src.deadline
    assert list(files) == []


def test_passes_serve_every_read_under_fresh_ids():
    reads = pool()
    src = PacedSource(reads, SEED, batch_size=4, seconds=60, lead=100)
    src.start()
    files = src.list_files()
    ids = [rid for _ in range(6) for _, rid in src.read_ids(next(files))]
    assert len(set(ids)) == len(ids) == 24
    for npass in range(3):
        served = [src.served[rid] for rid in ids[8 * npass:8 * npass + 8]]
        assert sorted(served) == list(range(8))
    assert src.batches[0] != src.batches[2]


def test_a_cpu_session_serves_and_judges_every_read():
    result = run.run_cell('demux.mrna', SEED, 1, device='cpu',
                          pool_reads=8, batch_size=4, judged_reads=8)
    assert result['correct'] is True
    assert result['failed'] == 0
    assert result['attempted'] >= 8
    assert result['checks']['judged_reads']['value'] == result['attempted']
    assert result['checks']['missing_rows']['value'] == 0
    assert list(result)[-1] == 'checks'


@pytest.mark.parametrize('status, failed', [('scaling_qc_fail', False),
                                            ('unknown_error', True)])
def test_a_read_without_a_row_counts_by_its_status(monkeypatch, status,
                                                   failed):
    """A read stopped before its label has no summary row: stopped by
    the scaling QC it is a result and completed, with an error it
    failed."""
    report = read.ReadRecord.report

    def stopped(self):
        rep = report(self)
        for key in ('label', 'sequence', 'barcode', 'polya'):
            rep.pop(key, None)
        rep['status'] = status
        return rep
    monkeypatch.setattr(read.ReadRecord, 'report', stopped)
    result = run.run_cell('demux.mrna', SEED, 1, device='cpu',
                          pool_reads=8, batch_size=4, judged_reads=8)
    assert result['attempted'] >= 8
    assert result['failed'] == (result['attempted'] if failed else 0)
