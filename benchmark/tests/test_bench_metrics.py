"""The readers of the per-layer metrics that read the program's spans and
counters, on synthetic runs: a run of a program that records them, and
one of a program without them, where each reads nothing."""

import types

import pytest

from benchmark import run


def traced_run(timer, batches=4):
    return types.SimpleNamespace(timer=timer, batches=batches)


TIMER = {
    'S:analyze_batch': (1.0, 4),
    'S:analyze_batch/cpu_ns': (0.0, 600_000_000),
    'W:compute_waits_load': (0.12, 2),
    'W:compute_handoff': (0.03, 3),
    'C:polya/launch': (0.5, 8),
    'C:polya/windows@8192': (0.0, 30),
    'C:polya/windows@16384': (0.0, 10),
    'C:polya/round': (0.9, 5),
}


def test_compute_idle_ms_per_batch():
    value = run.read_metric('session.compute_idle_ms_per_batch',
                            traced_run(TIMER))
    assert value == pytest.approx(1e3 * 0.15 / 4)


def test_compute_cpu_share():
    value = run.read_metric('analyzer.compute_cpu_share',
                            traced_run(TIMER))
    assert value == pytest.approx(60.0)


def test_windows_per_launch():
    value = run.read_metric('polya.windows_per_launch',
                            traced_run(TIMER))
    assert value == pytest.approx(5.0)


@pytest.mark.parametrize('name', ['session.compute_idle_ms_per_batch',
                                  'analyzer.compute_cpu_share',
                                  'polya.windows_per_launch'])
def test_reads_nothing_without_the_program_spans(name):
    parent = {k: v for k, v in TIMER.items()
              if not k.startswith(('W:', 'C:polya/windows@', 'S:'))}
    assert run.read_metric(name, traced_run(parent)) is None
    # the compute span's wall time alone, with no CPU counter beside it
    parent['S:analyze_batch'] = TIMER['S:analyze_batch']
    assert run.read_metric(name, traced_run(parent)) is None
