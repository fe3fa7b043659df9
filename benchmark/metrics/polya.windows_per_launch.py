"""Poly(A) rounds: the windows a launch carries, the ``C:polya/windows@*``
counters (one a window bucket) over the calls of ``C:polya/launch``."""


def read(run):
    windows = sum(n for name, (_, n) in run.timer.items()
                  if name.startswith('C:polya/windows@'))
    _, launches = run.timer.get('C:polya/launch', (0.0, 0))
    if not windows or not launches:
        return None
    return windows / launches
