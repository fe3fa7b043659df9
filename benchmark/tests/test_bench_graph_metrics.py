"""The reader of ``polya.graph_replay_share`` on synthetic runs: a run of a
program that counts its poly(A) graph captures and replays, and one of a
program without those counters, where it reads nothing."""

import types

import pytest

from benchmark import run


def traced_run(timer, batches=4):
    return types.SimpleNamespace(timer=timer, batches=batches)


TIMER = {
    'S:analyze_batch': (1.0, 4),
    'C:polya/launch': (0.5, 8),
    'C:polya/windows@8192': (0.0, 30),
    'C:polya/round': (0.9, 5),
    'C:polya/graph_replay': (0.0, 38),
    'C:polya/graph_capture': (0.0, 2),
    'C:polya/graph_pad_rows': (0.0, 57),
}


def test_graph_replay_share():
    value = run.read_metric('polya.graph_replay_share', traced_run(TIMER))
    assert value == pytest.approx(95.0)


def test_graph_replay_share_of_a_window_that_only_captured():
    captured = {k: v for k, v in TIMER.items()
                if k != 'C:polya/graph_replay'}
    assert run.read_metric('polya.graph_replay_share',
                           traced_run(captured)) == 0.0


def test_graph_replay_share_reads_nothing_without_the_counters():
    parent = {k: v for k, v in TIMER.items()
              if not k.startswith('C:polya/graph_')}
    assert run.read_metric('polya.graph_replay_share',
                           traced_run(parent)) is None
