"""Poly(A) rounds: the share of launch blocks that replayed a captured CUDA
graph, the counter ``C:polya/graph_replay`` over it and
``C:polya/graph_capture`` (a block whose graph was captured ran the round
op by op once)."""


def read(run):
    _, replays = run.timer.get('C:polya/graph_replay', (0.0, 0))
    _, captures = run.timer.get('C:polya/graph_capture', (0.0, 0))
    if not replays + captures:
        return None
    return 100.0 * replays / (replays + captures)
