"""The output check on the CPU, the harness's look for a card skipped:
with the timed path broken underneath, ``correct`` comes out false, once
for each fault a cell of this system can have; and the control, the
program's own 8-bit signal transport, fails the limit at this size too.
(A training step's unchanged state and the exchange between chips do
not exist here: the session trains nothing and runs on one card.)"""

from benchmark import run
from benchmark.harness import outputs
from poreplex_torch.pipeline import analyzer, read

SEED = 7 ** 12


def cpu_run(**kw):
    return run.run_cell('demux.mrna', SEED, 1, device='cpu',
                        pool_reads=8, batch_size=4, judged_reads=8, grace=5,
                        **kw)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    report = read.ReadRecord.report

    def altered(self):
        rep = report(self)
        if rep.get('sequence') is not None:
            seq, qual, trim = rep['sequence']
            rep['sequence'] = (seq[::-1], qual, trim)
        return rep
    monkeypatch.setattr(read.ReadRecord, 'report', altered)
    result = cpu_run()
    assert result['correct'] is False
    assert result['checks']['rows_differ_share']['value'] > \
        outputs.ROWS_DIFFER_LIMIT


def test_half_of_each_batch_left_out(monkeypatch):
    process = analyzer.BatchAnalyzer.process_batch

    def half(self, reads, preloaded=None):
        results, aux = process(self, reads, preloaded)
        return results[:len(results) // 2], aux
    monkeypatch.setattr(analyzer.BatchAnalyzer, 'process_batch', half)
    result = cpu_run()
    assert result['correct'] is False
    assert result['checks']['missing_rows']['value'] > 0
    assert result['failed'] > 0


def test_the_control_fails():
    result = run.run_cell('demux.mrna', SEED, 1, device='cpu',
                          pool_reads=32, batch_size=16, judged_reads=32,
                          wire='fast')
    assert result['correct'] is False
    assert result['checks']['rows_differ_share']['value'] > \
        outputs.ROWS_DIFFER_LIMIT


def test_the_polya_control_fails():
    """The reference's poly(A) round in bfloat16, in the program's place,
    against the float32 reference."""
    from benchmark.harness import traffic
    _, entry, _, _ = run.cell_entries(run.load_manifest(), 'full.mrna')
    config = run.load_json(entry['file'])
    params = dict(traffic.load('reads.mrna'), pool_reads=16,
                  pool_seed=12)
    pool = traffic.make_pool(params)
    sample = list(range(len(pool)))
    want = run.expected_outputs(config, pool, sample, 'cpu')
    low = run.expected_outputs(config, pool, sample, 'cpu',
                               polya_precision='bfloat16')
    ids = {str(i): i for i in sample}
    rows = {str(i): low[i][0] for i in sample if low[i][0]}
    fastq = {str(i): low[i][1] for i in sample if low[i][1]}
    numbers, _, _ = outputs.compare(ids, rows, fastq, want)
    assert numbers['dwell_gap'] > params['dwell_gap_limit_s']
