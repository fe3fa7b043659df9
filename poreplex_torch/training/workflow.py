"""End-to-end demultiplexer training workflow, the port's copy of
poreplex-tpu's ``training/workflow.py``.

The equivalent of the reference's Snakemake DAG
(training/barcodes/Snakefile + workflows/perform_training.py): one
barcoded control run per class is pushed through the production pipeline
with adapter-signal dumping, the dumped windows train the demux network
with the cost-matrix-weighted loss, the held-out split is evaluated into
``evaluation.txt`` (mirroring train_demux_nn.py:209-237's outputs), and
the phred calibration table is derived from held-out errors and embedded
in the checkpoint (compute_score_calibration_table.py's role).

Steps are skipped when their outputs already exist (Snakemake-style
freshness by presence; pass force=True to rebuild), so a failed run
resumes at the failed stage. Every stage runs on the CUDA device unless
the caller asks for the CPU: the sessions, the trainer (on one rank a
visible card with ``--data-parallel``) and the evaluation through the
serving model's LSTM kernels.

    python -m poreplex_torch.training.workflow \
        --run BC1=/runs/bc1 --run BC2=/runs/bc2 \
        --run BC3=/runs/bc3 --run BC4=/runs/bc4 -o training-out \
        [--data-parallel] [--cpu]
"""

import argparse
import glob
import gzip
import logging
import os
import re
import sys

import numpy as np
import torch

from ..config import resolve_device
from .train_demux import LABEL_IDS, train

INVENTORY_RELPATH = os.path.join('adapter-dumps', 'inventory.h5')

_CIGAR_M = re.compile(r'(\d+)M')


def _read_fastq_sequences(outdir):
    """(read_id, sequence) pairs from a prepare stage's FASTQ output."""
    for path in sorted(glob.glob(os.path.join(outdir, 'fastq', '*.fastq.gz'))):
        with gzip.open(path, 'rt') as f:
            while True:
                header = f.readline()
                if not header:
                    break
                seq = f.readline().rstrip('\n')
                f.readline()
                f.readline()
                yield header[1:].split()[0], seq


def _default_aligner_factory(reference):
    import mappy
    aligner = mappy.Aligner(reference, preset='map-ont', k=13)
    if not aligner:
        raise RuntimeError('failed to load reference ' + reference)
    return aligner


def _best_match_length(aligner, seq):
    """Total matched bases of the best hit (the reference's per-BAM score,
    training/barcodes/workflows/training_data_preparation.py:16-17:
    sum of CIGAR M runs, best alignment per read)."""
    best = 0
    for hit in aligner.map(seq):
        m = sum(int(n) for n in _CIGAR_M.findall(hit.cigar_str))
        best = max(best, m)
    return best


def filter_contaminated_reads(prepare_dirs, references, outdir,
                              make_aligner=None, min_score_ratio=0.55,
                              log=print):
    """Alignment-based contamination filter for the demux training data
    (role of training/barcodes/workflows/sequence_alignments.py +
    training_data_preparation.py:process_scores): every prepared run's
    basecalls are mapped against EVERY barcode's own transcriptome, each
    read is scored per reference by its best alignment's matched-base
    count, and a read survives only if the top-scoring reference is its
    own run's AND the best/(best+second) score ratio clears the cutoff —
    reads that align better (or comparably) to another barcode's
    transcriptome are cross-contamination and would poison the classes.

    prepare_dirs: {label: prepare outdir}; references: {label: ref path}.
    Writes tables/alignment-scores-<label>.tsv (the reference's
    tables/ artifacts) and returns {label: set(read_id)}."""
    make_aligner = make_aligner or _default_aligner_factory
    labels = sorted(references)
    aligners = {label: make_aligner(references[label]) for label in labels}
    tables_dir = os.path.join(outdir, 'tables')
    os.makedirs(tables_dir, exist_ok=True)

    keep = {}
    for label, pdir in sorted(prepare_dirs.items()):
        kept = set()
        rows = []
        for read_id, seq in _read_fastq_sequences(pdir):
            scores = {l: _best_match_length(aligners[l], seq)
                      for l in labels}
            ranked = sorted(scores.values(), reverse=True)
            best, second = ranked[0], (ranked[1] if len(ranked) > 1 else 0)
            assigned = max(labels, key=lambda l: scores[l])
            ratio = best / (best + second) if best else 0.0
            ok = (best > 0 and assigned == label and
                  ratio >= min_score_ratio)
            if ok:
                kept.add(read_id)
            rows.append([read_id] + [str(scores[l]) for l in labels] +
                        [assigned, '{:.4f}'.format(ratio),
                         'keep' if ok else 'drop'])
        table = os.path.join(tables_dir,
                             'alignment-scores-{}.tsv'.format(label))
        with open(table, 'w') as f:
            f.write('\t'.join(['read_id'] + labels +
                              ['assigned', 'score_ratio', 'verdict']) + '\n')
            for row in rows:
                f.write('\t'.join(row) + '\n')
        log('filter: {} -> kept {}/{} reads ({})'.format(
            label, len(kept), len(rows), table))
        keep[label] = kept
    return keep


def prepare_run(inputdir, outdir, log=print, config_overrides=None,
                device='cuda'):
    """Run the production session over one control run with adapter-signal
    dumping enabled, on ``device``; returns the dump inventory path."""
    from ..config import build_config
    from ..pipeline.session import ProcessingSession

    inventory = os.path.join(outdir, INVENTORY_RELPATH)
    if os.path.exists(inventory):
        log('prepare: {} up to date'.format(inventory))
        return inventory

    os.makedirs(outdir, exist_ok=True)
    config = build_config(inputdir, outdir, barcoding=False,
                          dump_adapter_signals=True, quiet=True,
                          device=device, **(config_overrides or {}))
    logger = logging.getLogger('poreplex-train-prepare')
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    if ProcessingSession.run(config, logger) is None:
        raise RuntimeError('prepare failed for ' + inputdir)
    if not os.path.exists(inventory):
        raise RuntimeError('prepare produced no dump inventory for ' +
                           inputdir)
    log('prepare: {} -> {}'.format(inputdir, inventory))
    return inventory


def evaluate(model_path, data, outpath, eval_fraction=0.25, log=print,
             device='cuda'):
    """Held-out evaluation report (accuracy, weighted accuracy by the
    training cost matrix, per-class counts) like the reference's
    ``models/*/evaluation.txt``, by the serving model on ``device``."""
    from ..models.demux import DemuxModel
    from .train_demux import DEFAULT_COST_MAT

    device = resolve_device(device)
    windows, labels = data
    n_eval = int(len(windows) * eval_fraction)
    eval_w, eval_l = windows[:n_eval], labels[:n_eval]
    model = DemuxModel(model_path, number_of_decoy_labels=1, device=device)
    with torch.inference_mode():
        probs = model(torch.as_tensor(np.asarray(eval_w, np.float32),
                                      device=device)).cpu().numpy()
    pred = probs.argmax(axis=1)

    acc = float((pred == eval_l).mean())
    weights = DEFAULT_COST_MAT[eval_l, pred]
    weighted_acc = float(((pred == eval_l) * weights).sum() / weights.sum())

    lines = ['accuracy\t{:.6f}'.format(acc),
             'weighted_accuracy\t{:.6f}'.format(weighted_acc),
             'n_eval\t{}'.format(len(eval_l))]
    names = {v: k for k, v in LABEL_IDS.items()}
    for label in sorted(set(int(v) for v in eval_l)):
        sel = eval_l == label
        lines.append('class_accuracy\t{}\t{:.6f}\t{}'.format(
            names.get(label, label), float((pred[sel] == label).mean()),
            int(sel.sum())))
    with open(outpath, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    log('evaluate: accuracy {:.4f} (weighted {:.4f}) -> {}'.format(
        acc, weighted_acc, outpath))
    return acc


def run_workflow(runs, outdir, steps=300, seed=0, force=False, log=print,
                 data_parallel=False, config_overrides=None,
                 references=None, make_aligner=None, min_score_ratio=0.55,
                 device='cuda'):
    """runs: list of (label_name, input_dir) with label_name one of
    decoy/BC1..BC4. ``references`` optionally maps label_name -> that
    barcode's transcriptome (minimap2-compatible reference); when given,
    the alignment-based contamination filter runs between prepare and
    train. Every stage runs on ``device``; data_parallel trains on one
    rank a device of parallel.mesh.select_devices (every visible card, or
    one CPU rank). Returns the held-out accuracy."""
    device = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    model_path = os.path.join(outdir, 'demux-model.npz')
    eval_path = os.path.join(outdir, 'evaluation.txt')
    if force:
        for path in (model_path, eval_path):
            if os.path.exists(path):
                os.unlink(path)

    prepare_dirs = {}
    for label_name, inputdir in runs:
        stage_dir = os.path.join(outdir, 'prepare', label_name)
        if force and os.path.exists(
                os.path.join(stage_dir, INVENTORY_RELPATH)):
            os.unlink(os.path.join(stage_dir, INVENTORY_RELPATH))
        prepare_run(inputdir, stage_dir, log=log,
                    config_overrides=config_overrides, device=device)
        prepare_dirs[label_name] = stage_dir

    keep = None
    if references:
        keep = filter_contaminated_reads(
            prepare_dirs, references, outdir, make_aligner=make_aligner,
            min_score_ratio=min_score_ratio, log=log)

    inventories = []
    for label_name, _ in runs:
        inventories.append(
            (os.path.join(prepare_dirs[label_name], INVENTORY_RELPATH),
             LABEL_IDS[label_name],
             keep.get(label_name) if keep is not None else None))

    from .data import dumps_dataset
    data = dumps_dataset(inventories, rng=np.random.RandomState(seed))
    if len(data[0]) == 0:
        raise RuntimeError('no adapter windows dumped by the prepare stage')

    devices = None
    if data_parallel:
        from ..parallel.mesh import select_devices
        devices = select_devices({'device': device})

    if os.path.exists(model_path):
        log('train: {} up to date'.format(model_path))
    else:
        train(model_path, steps=steps, seed=seed, data=data, log=log,
              device=device, devices=devices)

    if os.path.exists(eval_path):
        log('evaluate: {} up to date'.format(eval_path))
        with open(eval_path) as f:
            return float(f.readline().split('\t')[1])
    return evaluate(model_path, data, eval_path, log=log, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', action='append', required=True,
                        metavar='LABEL=FAST5_DIR',
                        help='barcoded control run; LABEL one of '
                             'decoy/BC1..BC4; repeatable')
    parser.add_argument('-o', '--output', required=True)
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--force', action='store_true',
                        help='rebuild all stages')
    parser.add_argument('--data-parallel', action='store_true',
                        help='train on one rank a visible card (one CPU '
                             'rank with --cpu)')
    parser.add_argument('--cpu', default=False, action='store_true',
                        help='run every stage on the CPU instead of the '
                             'CUDA device')
    args = parser.parse_args(argv)

    runs = []
    for spec in args.run:
        label, path = spec.split('=', 1)
        if label not in LABEL_IDS:
            parser.error('unknown label ' + label)
        runs.append((label, path))
    run_workflow(runs, args.output, steps=args.steps, seed=args.seed,
                 force=args.force, data_parallel=args.data_parallel,
                 device='cpu' if args.cpu else 'cuda')


if __name__ == '__main__':
    sys.exit(main())
