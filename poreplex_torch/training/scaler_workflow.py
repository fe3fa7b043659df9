"""End-to-end signal-scaler training workflow, the port's copy of
poreplex-tpu's ``training/scaler_workflow.py``.

DAG role of the reference's training/signal-scaling/Snakefile: per-run
signal/target extraction, balanced subsampling, outlier purification,
train/test split with target redispersion, LSTM training, and a
Pearson-r/RMSD evaluation — with Snakemake-style freshness skipping
(stages with existing outputs are reused; force=True rebuilds).

Per-read targets follow extract-signals.py: group basecalled events by
``pos = cumsum(move)``, drop jump positions (move > 1, and the position
before) and flip-flop padding states, take the per-position median event
level, and Theil-Sen-regress the kmer model's expected level on it —
``level ~ scale * mean + shift`` is exactly the affine the production
scaler predicts. The signal snippet is the production scaler input: the
first 30k raw-pA samples stride-15 pooled, left-zero-padded to 2000.
The trainer and the evaluation, through the serving model's LSTM kernel,
run on the CUDA device unless the caller asks for the CPU.

    python -m poreplex_torch.training.scaler_workflow \
        --run /runs/cc1 --run /runs/hela1 -o scaler-training-out [--cpu]
"""

import argparse
import csv
import json
import logging
import os
import sys

import numpy as np

from ..config import resolve_device

RANDOM_SEED = 922                # the reference DAG's fixed seed
OUTLIER_CONTAMINATION = 0.02     # Snakefile: OUTLIER_CONTAMINATION
TESTSET_SPLIT = 0.2              # Snakefile: TESTSET_SPLIT
TRAINING_STDEV_BOOST = 1.8       # Snakefile: TRAINING_STDEV_BOOST
MINIMUM_NONJUMP_POSITIONS = 30   # extract-signals.py:33


def read_kmer_levels(path):
    """{k-mer: expected level} of a k-mer model table: its ``level_mean``
    column, else the first column after the k-mer."""
    with open(path, newline='') as f:
        rows = csv.reader(f, delimiter='\t')
        header = next(rows)
        col = header.index('level_mean') if 'level_mean' in header else 1
        return {row[0]: float(row[col]) for row in rows}


def calculate_scaling_params(events, kmer_levels,
                             min_positions=MINIMUM_NONJUMP_POSITIONS):
    """(scale, shift) with level ~= scale * raw_mean + shift, or None
    (extract-signals.py:calculate_scaling_params)."""
    move = np.asarray(events['move'], np.int64)
    pos = np.cumsum(move)
    mean = np.asarray(events['mean'], np.float64)
    states = np.asarray(events['model_state'])

    jumps = set(pos[move > 1].tolist())
    jumps |= {p - 1 for p in jumps}
    if len(set(pos.tolist()) - jumps) < min_positions:
        return None

    starts = np.nonzero(np.concatenate([[True], pos[1:] != pos[:-1]]))[0]
    xs, ys = [], []
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < len(starts) else len(pos)
        state = states[s]
        state = state.decode() if isinstance(state, bytes) else str(state)
        if '_' in state or int(pos[s]) in jumps or state not in kmer_levels:
            continue
        xs.append(np.median(mean[s:e]))
        ys.append(kmer_levels[state])
    if len(xs) < min_positions:
        return None

    from sklearn.linear_model import TheilSenRegressor
    regr = TheilSenRegressor(random_state=RANDOM_SEED)
    regr.fit(np.asarray(xs)[:, None], np.asarray(ys))
    return float(regr.coef_[0]), float(regr.intercept_)


def _signal_head(f5, stride=15, length=30000, count=2000):
    """Production scaler input from one read (extract-signals.py
    read_raw_signal): first ``length`` raw-pA samples pooled by
    ``stride``, left-zero-padded to ``count`` windows."""
    raw = f5.get_raw_dac()
    n = min(length, len(raw)) // stride
    pooled = raw[:n * stride].reshape(n, stride).mean(
        axis=1, dtype=np.float64)
    pooled = f5.pa_scale * (pooled + f5.offset)
    if len(pooled) < count:
        pooled = np.pad(pooled, [count - len(pooled), 0], 'constant')
    return pooled.astype(np.float32)


def extract_run(inputdir, kmer_levels, signals_out, scaling_out, log=print):
    """One run directory -> (signals [N, 2000], scaling [N, 2]) .npy pair
    (rules extract_signals_and_scales + convert_extracted_signals)."""
    if os.path.exists(signals_out) and os.path.exists(scaling_out):
        log('extract: {} up to date'.format(signals_out))
        return
    from .. import fast5 as fast5mod

    signals, targets = [], []
    for dirpath, _dirs, files in sorted(os.walk(inputdir)):
        for fn in sorted(files):
            if not fn.endswith('.fast5'):
                continue
            path = os.path.join(dirpath, fn)
            for _f, read_id in fast5mod.get_read_ids(path):
                try:
                    f5 = fast5mod.Fast5Reader(path, read_id)
                except Exception:
                    continue
                try:
                    bcall = f5.get_basecall()
                    if bcall is None:
                        continue
                    params = calculate_scaling_params(bcall['events'],
                                                      kmer_levels)
                    if params is None:
                        continue
                    signals.append(_signal_head(f5))
                    targets.append(params)
                finally:
                    f5.close()
    signals = (np.stack(signals) if signals
               else np.zeros((0, 2000), np.float32))
    targets = np.asarray(targets, np.float64).reshape(-1, 2)
    np.save(signals_out, signals)
    np.save(scaling_out, targets)
    log('extract: {} -> {} reads'.format(inputdir, len(signals)))


def purify(signals, targets, contamination=OUTLIER_CONTAMINATION):
    """Outlier exclusion on the target parameters (rule exclude_outliers:
    IsolationForest on the (scale, shift) rows)."""
    if len(targets) < 20:
        return signals, targets
    from sklearn.ensemble import IsolationForest
    ifor = IsolationForest(contamination=contamination,
                           random_state=RANDOM_SEED)
    ifor.fit(targets)
    inlier = ifor.predict(targets) > 0
    return signals[inlier], targets[inlier]


def split_and_redisperse(signals, targets, rng, test_split=TESTSET_SPLIT,
                         stdev_boost=TRAINING_STDEV_BOOST):
    """Train/test split with training-target redispersion (rule
    split_testing_set): training signals are normalized to the canonical
    model with their TRUE affine, then re-distorted by randomized
    targets drawn wider than the empirical spread (stdev boost) so the
    network sees a balanced target distribution; outputs standardized by
    the recorded transform."""
    n = len(signals)
    order = rng.permutation(n)
    n_train = int(n * (1 - test_split))
    tr, te = sorted(order[:n_train]), sorted(order[n_train:])
    tr_x, tr_y = signals[tr], targets[tr]
    te_x, te_y = signals[te], targets[te]

    mean = tr_y.mean(axis=0)
    std = tr_y.std(axis=0) * stdev_boost
    std = np.maximum(std, 1e-6)

    canonical = tr_x * tr_y[:, 0:1] + tr_y[:, 1:2]
    redist = np.stack([rng.normal(mean[0], std[0], len(tr_y)),
                       rng.normal(mean[1], std[1], len(tr_y))], axis=1)
    # the boosted stdev can draw scales at/below zero when the empirical
    # mean/std ratio is small; dividing by those would poison the
    # training signals — clamp away from zero (scales are physical
    # gains, strictly positive)
    redist[:, 0] = np.maximum(redist[:, 0], max(1e-3, 0.05 * mean[0]))
    tr_x2 = (canonical - redist[:, 1:2]) / redist[:, 0:1]

    transform = {'scale_mean': float(mean[0]), 'scale_std': float(std[0]),
                 'shift_mean': float(mean[1]), 'shift_std': float(std[1])}
    return ((tr_x2.astype(np.float32), redist.astype(np.float32)),
            (te_x.astype(np.float32), te_y.astype(np.float32)), transform)


def evaluate(model_path, test_x, test_y, outpath, log=print, device='cuda'):
    """Pearson r + RMSD per output on the held-out reads
    (learn-scaling.py:evaluate_model), by the serving model on
    ``device``."""
    from ..models.scaler import ScalerModel

    model = ScalerModel(model_path, 0.001, device=device)
    pred, _qc = model.predict(test_x)

    lines = []
    for i, name in enumerate(('scale', 'shift')):
        if len(test_y) >= 2:
            r = float(np.corrcoef(test_y[:, i], pred[:, i])[0, 1])
        else:
            r = float('nan')
        rmsd = float(np.sqrt(((test_y[:, i] - pred[:, i]) ** 2).mean()))
        lines.append('pearson_r\t{}\t{:.5f}'.format(name, r))
        lines.append('rmsd\t{}\t{:.5f}'.format(name, rmsd))
    lines.append('n_test\t{}'.format(len(test_y)))
    with open(outpath, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    log('evaluate: -> ' + outpath)
    return lines


def run_workflow(runs, outdir, kmer_model, steps=300, force=False,
                 log=print, device='cuda'):
    """runs: list of input FAST5 directories (basecalled). The trainer and
    the evaluation run on ``device``. Returns the evaluation lines."""
    device = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    model_path = os.path.join(outdir, 'scaler-model.npz')
    eval_path = os.path.join(outdir, 'evaluation.txt')
    if force:
        for stale in (model_path, eval_path):
            if os.path.exists(stale):
                os.unlink(stale)

    kmer_levels = read_kmer_levels(kmer_model)

    arrays_dir = os.path.join(outdir, 'dataarrays')
    os.makedirs(arrays_dir, exist_ok=True)
    per_run = []
    for i, inputdir in enumerate(runs):
        sig = os.path.join(arrays_dir, 'signals-run{}.npy'.format(i))
        sca = os.path.join(arrays_dir, 'scaling-run{}.npy'.format(i))
        if force:
            for stale in (sig, sca):
                if os.path.exists(stale):
                    os.unlink(stale)
        extract_run(inputdir, kmer_levels, sig, sca, log=log)
        per_run.append((np.load(sig), np.load(sca)))

    # balanced subsampling across runs (rule subsample_for_balanced_weights)
    sizes = [len(s) for s, _ in per_run if len(s)]
    if not sizes:
        raise RuntimeError('no reads with usable scaling targets')
    m = min(sizes)
    rng = np.random.RandomState(RANDOM_SEED)
    sig_parts, tgt_parts = [], []
    for s, t in per_run:
        if not len(s):
            continue
        idx = sorted(rng.permutation(len(s))[:m])
        sig_parts.append(s[idx])
        tgt_parts.append(t[idx])
    signals = np.concatenate(sig_parts)
    targets = np.concatenate(tgt_parts)

    signals, targets = purify(signals, targets)
    train_set, test_set, transform = split_and_redisperse(
        signals, targets, rng)
    with open(os.path.join(outdir, 'scaling-transform.json'), 'w') as f:
        json.dump(transform, f)

    if os.path.exists(model_path):
        log('train: {} up to date'.format(model_path))
    else:
        from .train_scaler import train
        train(model_path, steps=steps, seed=RANDOM_SEED,
              data=train_set, log=log, device=device)

    if os.path.exists(eval_path):
        log('evaluate: {} up to date'.format(eval_path))
        with open(eval_path) as f:
            return f.read().splitlines()
    return evaluate(model_path, test_set[0], test_set[1], eval_path,
                    log=log, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', action='append', required=True,
                        metavar='FAST5_DIR', help='basecalled run dir; '
                        'repeatable')
    parser.add_argument('-o', '--output', required=True)
    parser.add_argument('--kmer-model', default=None)
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--force', action='store_true')
    parser.add_argument('--cpu', default=False, action='store_true',
                        help='train and evaluate on the CPU instead of the '
                             'CUDA device')
    args = parser.parse_args(argv)

    kmer_model = args.kmer_model
    if kmer_model is None:
        from ..config import load_preset
        kmer_model = load_preset()['kmer_model']
    run_workflow(args.run, args.output, kmer_model, steps=args.steps,
                 force=args.force, device='cpu' if args.cpu else 'cuda')


if __name__ == '__main__':
    sys.exit(main())
