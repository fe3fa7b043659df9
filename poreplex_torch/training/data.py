"""Synthetic training-data generators.

The reference trains from real MinION runs prepared by Snakemake pipelines
(training/barcodes/scripts/prepare_training_data.py,
training/signal-scaling/scripts/extract-signals.py). Those datasets are not
redistributable; these generators produce structurally equivalent synthetic
data — barcode-specific adapter signal signatures and scaling-target signal
heads — so the training loop, losses, calibration and checkpoint formats
are exercised end to end and new models can be trained when real data is
available (drop-in: the loaders just yield (window, label) / (head,
scale, shift) pairs).

The port's own copy of poreplex-tpu's ``training/data.py``: numpy only,
drawing from a ``numpy.random.RandomState`` in the same order, so the same
seed gives the same datasets in both packages. h5py is imported only
inside ``load_adapter_windows``.
"""

import numpy as np

# Distinct per-barcode adapter signatures: each barcode modulates the
# adapter current with a characteristic low-frequency pattern.
BARCODE_FREQS = [0.011, 0.023, 0.037, 0.053]
BARCODE_AMPS = [6.0, 5.0, 4.5, 5.5]


def make_adapter_window(rng, barcode, trim_length=300):
    """One med/MAD-normalized adapter window. barcode: -1 for decoy (random
    signal), 0..3 for barcodes."""
    t = np.arange(trim_length)
    base = rng.normal(80.5, 5.0, trim_length)
    if barcode >= 0:
        base += BARCODE_AMPS[barcode] * np.sin(
            2 * np.pi * BARCODE_FREQS[barcode] * t +
            rng.uniform(0, 2 * np.pi))
        base += BARCODE_AMPS[barcode] * 0.6 * np.sign(
            np.sin(2 * np.pi * BARCODE_FREQS[barcode] * 0.5 * t))
    med = np.median(base)
    mad = np.median(np.abs(base - med))
    return ((base - med) / max(0.01, mad * 1.4826)).astype(np.float32)


def demux_dataset(n_per_class, rng, trim_length=300, decoy_fraction=0.2):
    """Returns (windows [N, T], labels [N]) with label 0 = decoy,
    1..4 = barcodes (the reference's label layout: decoys first,
    poreplex/barcoding.py:108)."""
    windows, labels = [], []
    n_decoy = int(n_per_class * 4 * decoy_fraction)
    for _ in range(n_decoy):
        windows.append(make_adapter_window(rng, -1, trim_length))
        labels.append(0)
    for bc in range(4):
        for _ in range(n_per_class):
            windows.append(make_adapter_window(rng, bc, trim_length))
            labels.append(bc + 1)
    order = rng.permutation(len(windows))
    return (np.stack(windows)[order],
            np.asarray(labels, np.int32)[order])


def normalize_signal(sig):
    """med/MAD normalization of the reference's training prep AND runtime
    demuxer (training/barcodes/scripts/prepare_training_data.py:62-65,
    poreplex/barcoding.py:77-81)."""
    med = np.median(sig)
    mad = np.median(np.abs(sig - med))
    return (sig - med) / max(0.01, mad * 1.4826)


def load_adapter_windows(inventory_path, trim_length=300, read_ids=None,
                         pad_value=-1000.0):
    """Load normalized fixed-length adapter windows from an adapter-signal
    dump inventory (the `--dump-adapter-signals` output; identical HDF5
    layout to the reference: `adapter/<read_id[:3]>/<read_id>` datasets).
    Mirrors training/barcodes/scripts/prepare_training_data.py:69-87: trim
    to the LAST trim_length samples then normalize, or normalize the whole
    signal and left-pad with -1000.

    Returns (windows [N, trim_length] f32, read_ids list)."""
    import h5py
    windows, ids = [], []
    with h5py.File(inventory_path, 'r') as h5:
        siggroup = h5['adapter']
        if read_ids is None:
            read_ids = [rid for grp in siggroup.values() for rid in grp]
        for read_id in read_ids:
            signal = siggroup['{}/{}'.format(read_id[:3], read_id)][:]
            if len(signal) < trim_length:
                signal = np.pad(normalize_signal(signal),
                                (trim_length - len(signal), 0), 'constant',
                                constant_values=pad_value)
            elif len(signal) > trim_length:
                signal = normalize_signal(signal[-trim_length:])
            else:
                signal = normalize_signal(signal)
            windows.append(signal.astype(np.float32))
            ids.append(read_id)
    return (np.stack(windows) if windows
            else np.zeros((0, trim_length), np.float32)), ids


def dumps_dataset(runs, trim_length=300, rng=None):
    """Build a demux training set from per-class dump inventories.

    runs: list of (inventory_path, label[, keep_read_ids]) with label
    0 = decoy, 1..4 = barcodes (one barcoded control run per class, the
    reference's training design: training/barcodes/Snakefile). The
    optional keep set restricts a run to the given read ids (for example
    reads that passed a contamination filter). Returns shuffled
    (windows [N, T], labels [N])."""
    windows, labels = [], []
    for entry in runs:
        path, label = entry[0], entry[1]
        keep = entry[2] if len(entry) > 2 else None
        w, ids = load_adapter_windows(path, trim_length)
        if keep is not None:
            sel = np.fromiter((rid in keep for rid in ids), bool, len(ids))
            w = w[sel]
        windows.append(w)
        labels.append(np.full(len(w), label, np.int32))
    windows = np.concatenate(windows) if windows else \
        np.zeros((0, trim_length), np.float32)
    labels = np.concatenate(labels) if labels else np.zeros(0, np.int32)
    order = (rng or np.random).permutation(len(windows))
    return windows[order], labels[order]


def scaler_dataset(n, rng, pooled_length=2000, stride=15):
    """Signal heads + ground-truth (scale, shift) targets: a canonical
    pore-model-space head is generated, then distorted by the inverse of a
    random per-read (scale, shift); the network must recover the affine
    correction (the reference's regression target,
    training/signal-scaling/scripts/learn-scaling.py)."""
    heads = np.zeros((n, pooled_length), np.float32)
    targets = np.zeros((n, 2), np.float32)
    for i in range(n):
        scale = rng.normal(0.955, 0.074)     # matches output_transform stats
        shift = rng.normal(5.50, 5.46)
        nstates = pooled_length // 20
        levels = rng.normal(92.0, 12.0, nstates)
        canonical = np.repeat(levels, 20)[:pooled_length] + \
            rng.normal(0, 2.0, pooled_length)
        # distorted raw signal: canonical = scale * raw + shift
        raw = (canonical - shift) / scale
        pad = rng.randint(0, pooled_length // 3) if rng.uniform() < 0.3 else 0
        if pad:
            raw[:pad] = 0.0
        heads[i] = raw
        targets[i] = (scale, shift)
    return heads, targets
