"""The run that the per-layer readers see in a cell of several ranks,
built from synthetic rank reports: timers and batches summed, so a
per-batch metric is the mean rank's; the mean card's busy time; every
card's device spans; the peak of every card; and the finish spread over
the ranks' windows. Also the merged counts' check."""

import types

import pytest

from benchmark import run
from benchmark.harness import counts, ranks


class Work:
    """One operation and one least second a frame."""

    def ops(self, frames):
        return frames

    def least_seconds(self, frames):
        return frames


def report(timer, batches, spans):
    return {'timer': timer, 'batches': batches, 'device_spans': spans,
            'host_spans': [('A:fast5_load', 0.0, 1.0, 1)]}


REPORTS = [
    report({'B:device_stage1': (3.0, 6), 'A:fast5_load': (2.0, 6)}, 6,
           [(0.0, 2.0, 'lstm2_stacked_kernel'), (3.0, 4.0, 'gatherMedian')]),
    report({'B:device_stage1': (1.0, 4), 'C:polya': (0.5, 4)}, 4,
           [(1.0, 2.0, 'viterbi_extents_kernel')]),
]
WINDOWS = [(0.0, 10.0), (0.5, 8.0)]


def merged(reports=REPORTS, windows=WINDOWS, traced=True):
    if not traced:
        reports = [dict(r, device_spans=None) for r in reports]
    return ranks.merged_run(reports, windows, Work(), [10, 20, 30],
                            [10, 20], counts.PEAK_FP32)


def test_timers_and_batches_are_summed():
    m = merged()
    assert m.timer['B:device_stage1'] == (4.0, 10)
    assert m.timer['A:fast5_load'] == (2.0, 6)
    assert m.timer['C:polya'] == (0.5, 4)
    assert m.batches == 10
    # a per-batch metric is the mean rank's
    assert run.read_metric('engine.stage1_ms_per_batch', m) == \
        pytest.approx(400.0)
    assert run.read_metric('polya.ms_per_batch', m) == pytest.approx(50.0)


def test_busy_is_the_mean_cards_and_the_window_spans_every_rank():
    m = merged()
    assert m.window_s == pytest.approx(10.0)
    # card 0 busy 3 s of the window, card 1 1 s
    assert m.busy_s == pytest.approx(2.0)
    assert run.read_metric('device.idle_share', m) == pytest.approx(80.0)
    assert m.host_spans == REPORTS[0]['host_spans']


def test_every_cards_spans_and_peak():
    m = merged()
    assert len(m.device_spans) == 3
    assert m.peak_fp32 == 2 * counts.PEAK_FP32
    # stage-1 kernels: 2 s on card 0 and 1 s on card 1
    assert run.read_metric('kernels.stage1_roofline', m) == \
        pytest.approx(100.0 * 60 / 3.0)
    assert run.read_metric('device.mfu', m) == pytest.approx(
        100.0 * 30 / (10.0 * 2 * counts.PEAK_FP32))


def test_untraced_reports_read_no_device_metric():
    m = merged(traced=False)
    assert m.device_spans is None and m.busy_s is None
    assert run.read_metric('device.idle_share', m) is None
    assert run.read_metric('kernels.stage1_roofline', m) is None


def test_a_rank_without_a_report():
    m = ranks.merged_run([REPORTS[0], None], WINDOWS, Work(), [], [],
                         counts.PEAK_FP32)
    assert m.batches == 6 and m.busy_s == pytest.approx(3.0)
    assert m.peak_fp32 == 2 * counts.PEAK_FP32


@pytest.mark.parametrize('windows, share', [
    ([(0.0, 10.0), (0.5, 8.0)], 20.0),
    ([(0.0, 10.0), (0.0, 10.0), (0.1, 10.0), (0.0, 10.0)], 0.0),
    ([(0.0, 20.0), (1.0, 16.0), (0.5, 19.0), (0.0, 17.0)], 20.0)])
def test_finish_spread_share(windows, share):
    m = ranks.merged_run([None] * len(windows), windows, Work(), [], [],
                         counts.PEAK_FP32)
    assert run.read_metric('ranks.finish_spread_share', m) == \
        pytest.approx(share)


def test_finish_spread_reads_nothing_in_one_process():
    single = types.SimpleNamespace(timer={}, batches=4, window_s=30.0)
    assert run.read_metric('ranks.finish_spread_share', single) is None


OWN = [{('pass', 'BC1', 'okay'): 5, ('fail', None, 'unsplit_read'): 1},
       {('pass', 'BC1', 'okay'): 3, ('pass', 'BC2', 'okay'): 2}]


@pytest.mark.parametrize('merged, differ', [
    ({('pass', 'BC1', 'okay'): 8, ('fail', None, 'unsplit_read'): 1,
      ('pass', 'BC2', 'okay'): 2}, 0),
    ({('pass', 'BC1', 'okay'): 5, ('fail', None, 'unsplit_read'): 1}, 2),
    ({('pass', 'BC1', 'okay'): 8, ('fail', None, 'unsplit_read'): 1,
      ('pass', 'BC2', 'okay'): 2, ('pass', 'BC3', 'okay'): 1}, 1),
    (None, 3)], ids=['sum', 'exchange left out', 'extra cell', 'no merge'])
def test_merged_counts_differ(merged, differ):
    assert ranks.merged_counts_differ(OWN, merged) == differ


def test_a_rank_without_counts_fails_the_merge_check():
    assert ranks.merged_counts_differ([OWN[0], None], OWN[0]) == 2
    assert ranks.merged_counts_differ([None, None], None) == 1
