"""Ranks: the last rank's return from ``main`` less the first rank's, over
the window, in percent: the share of the window in which some cards sit
finished while another rank ends. Nothing to read in a run of one
process."""


def read(run):
    windows = getattr(run, 'rank_windows', None)
    if not windows or len(windows) < 2 or run.window_s <= 0:
        return None
    ends = [t1 for _, t1 in windows]
    return 100.0 * (max(ends) - min(ends)) / run.window_s
