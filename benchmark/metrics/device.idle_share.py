"""Device: the share of the traced window, in percent, in which no
kernel or copy ran on the card."""


def read(run):
    if run.device_spans is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
