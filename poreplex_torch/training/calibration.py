"""Score -> phred calibration table generation.

Re-implements the reference's held-out calibration procedure
(training/barcodes/scripts/compute_score_calibration_table.py:48-187):
multiscale sliding-window error rates over score-sorted predictions, a
tricube-weighted local-linear smoother standing in for R's loess, per-phred
root finding on the smoothed error curve, and a linear extrapolation of the
score->error relation below the lowest well-sampled score. The committed
table format is a monotone array of 29 scores indexed by phred 0..28
(presets/MIN106-RNA001/demux-tetra-r4.hdf5 `poreplex_params/calibration`,
looked up with bisect at poreplex/barcoding.py:72-75).

Small held-out sets cannot fill the reference's window sizes (>= 500
predictions per window); those fall back to a direct cumulative-error-rate
threshold scan, which converges to the same table as data grows.

The port's own copy of poreplex-tpu's ``training/calibration.py`` (numpy
only); both give the same table from the same scores.
"""

import numpy as np

# [window_size, minimum_size, interval] per scale, finest last
SCORING_BINNING_PARAMS = [
    (10000, 2500, 3300),
    (2000, 1000, 1000),
    (1000, 500, 500),
]
SCORING_STDEV_THRESHOLD = 0.02
EXTRAPOLATION_SUPPORT_POINTS = 3
INTERPOLATION_LOESS_ALPHA = 0.3


def local_linear_smooth(x, y, px, alpha=INTERPOLATION_LOESS_ALPHA):
    """loess(degree=1, span=alpha) equivalent: at each prediction point,
    fit a tricube-weighted line through the nearest ceil(alpha*n) samples."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    k = max(2, int(np.ceil(alpha * len(x))))
    out = np.empty(len(px), np.float64)
    for i, x0 in enumerate(px):
        d = np.abs(x - x0)
        sel = np.argpartition(d, min(k, len(x)) - 1)[:k]
        dmax = d[sel].max()
        w = (1.0 - (d[sel] / dmax) ** 3) ** 3 if dmax > 0 else \
            np.ones(len(sel))
        xs, ys = x[sel], y[sel]
        sw = w.sum()
        mx, my = (w * xs).sum() / sw, (w * ys).sum() / sw
        var = (w * (xs - mx) ** 2).sum()
        slope = (w * (xs - mx) * (ys - my)).sum() / var if var > 0 else 0.0
        out[i] = my + slope * (x0 - mx)
    return out


def scan_error_rates(scores, correct, window_size, min_width, interval):
    """Windowed error rates over descending-score order; returns one row
    per window: (error_rate, score_mean, score_std)."""
    n = len(scores)
    rows = []
    for start in range(0, n - min_width + 1, interval):
        end = min(n, start + window_size)
        win_scores = scores[start:end]
        rows.append(((~correct[start:end]).mean(),
                     win_scores.mean(), win_scores.std(ddof=1)))
    return np.array(rows, np.float64).reshape(-1, 3)


def build_multiscale_error_table(scores, correct):
    """Coarse-to-fine windows: each finer scale only contributes below the
    score range the coarser scale sampled stably (score_std threshold)."""
    table = None
    for params in SCORING_BINNING_PARAMS:
        if len(scores) < params[1]:
            continue
        stat = scan_error_rates(scores, correct, *params)
        if table is None:
            table = stat
        else:
            stable = table[table[:, 2] < SCORING_STDEV_THRESHOLD]
            if len(stable) == 0:
                stable = table
            lowest_stable = stable[:, 1].min()
            table = np.vstack([stable, stat[stat[:, 1] < lowest_stable]])
    return table


def _cumulative_fallback(scores, correct, max_phred):
    """Small-data method: minimum score at which the cumulative error rate
    from the top stays below each phred target."""
    n = len(scores)
    table = np.zeros(max_phred + 1, np.float64)
    if n == 0:
        return table
    cum_err = np.cumsum(~correct) / np.arange(1, n + 1)
    for phred in range(1, max_phred + 1):
        target = 10 ** (-phred / 10)
        ok = np.nonzero(cum_err <= target)[0]
        table[phred] = scores[ok[-1]] if len(ok) else 1.0
    return np.maximum.accumulate(table)


def _crossing_score(px, py, target):
    """Score at which the smoothed error curve crosses ``target``
    (py decreases with px overall); None when no crossing exists."""
    diff = py - target
    signs = np.sign(diff)
    flips = np.nonzero(signs[:-1] * signs[1:] < 0)[0]
    if len(flips) == 0:
        if (diff <= 0).all():
            return px[0]      # already below target everywhere
        return None           # unattainable in the sampled range
    i = flips[-1]             # the final descent through the target
    frac = diff[i] / (diff[i] - diff[i + 1])
    return px[i] + frac * (px[i + 1] - px[i])


def build_calibration_table(scores, correct, max_phred=28):
    """Full reference procedure; returns scores[phred] for phred 0..max."""
    scores = np.asarray(scores, np.float64)
    correct = np.asarray(correct, bool)
    order = np.argsort(-scores)
    scores, correct = scores[order], correct[order]

    errortbl = build_multiscale_error_table(scores, correct)
    if errortbl is None or \
            len(errortbl) < EXTRAPOLATION_SUPPORT_POINTS + 2:
        return _cumulative_fallback(scores, correct, max_phred)

    table = np.full(max_phred + 1, 1.0, np.float64)
    table[0] = 0.0
    score_lo = errortbl[-1, 1]
    score_hi = errortbl[0, 1]

    # Low-score range: linear fit error ~ a*score + b over the lowest
    # supports, inverted to score(phred targets).
    supports = errortbl[-EXTRAPOLATION_SUPPORT_POINTS:]
    a, b = np.polyfit(supports[:, 1], supports[:, 0], 1)
    extrapol_phred_max = min(max_phred,
                             int(-np.log10(max(score_lo, 1e-12)) * 10))
    for phred in range(1, extrapol_phred_max + 1):
        if a != 0:
            table[phred] = (10 ** (-phred / 10) - b) / a

    # Well-sampled range: smoothed error curve, one root per phred target.
    top_error = errortbl[0, 0]
    interpol_phred_max = max_phred if top_error <= 0 else \
        min(max_phred, int(-np.log10(top_error) * 10))
    px = np.sort(np.hstack([np.linspace(score_lo, score_hi, 100),
                            errortbl[:, 1]]))
    py = local_linear_smooth(errortbl[:, 1], errortbl[:, 0], px)
    for phred in range(extrapol_phred_max + 1, interpol_phred_max + 1):
        root = _crossing_score(px, py, 10 ** (-phred / 10))
        if root is not None:
            table[phred] = root

    return np.clip(np.maximum.accumulate(table), 0.0, 1.0)


def compute_calibration_table(scores, correct, max_phred=28):
    """Dispatch: the multiscale procedure once the held-out set can fill
    the reference's smallest window; the cumulative method otherwise."""
    if len(scores) >= 2 * SCORING_BINNING_PARAMS[-1][1]:
        return build_calibration_table(scores, correct, max_phred)
    scores = np.asarray(scores, np.float64)
    correct = np.asarray(correct, bool)
    order = np.argsort(-scores)
    return _cumulative_fallback(scores[order], correct[order], max_phred)
