"""The port's training workflows (poreplex_torch/training/workflow.py and
scaler_workflow.py) against poreplex-tpu's on the CPU, on the fixtures of
tests/test_training.py's workflow tests at fewer reads and steps.

Demux: two barcoded runs of 8 reads each through both packages'
``run_workflow`` (the reduced presets of test_torch_commandline, two
steps). The prepared dump inventories hold the same reads, their signals
within SCALED_RTOL (they are scaled frames) and their windows within
WINDOW_ATOL; the contamination filter with the same fake aligner keeps the
same reads and writes the same score tables; the port's ``evaluate`` of
the JAX-trained checkpoint writes JAX's ``evaluation.txt``; a second
``run_workflow`` reuses every stage; the port's checkpoint loads in both
packages.

Scaler: two basecalled runs of 10 reads each, their event means rewritten
as a per-read affine of the k-mer levels (as test_training does), through
both packages' ``run_workflow`` (one step): the k-mer table read with csv
equals pandas', ``extract_run``, ``purify`` and ``split_and_redisperse``
give equal arrays, ``evaluate`` of the JAX-trained checkpoint writes JAX's
``evaluation.txt``, a second run reuses every stage, and the port's
checkpoint loads in both packages.
"""

import os

import numpy as np
import pytest
import torch

from poreplex_tpu.simulate import make_fixture_dir
from poreplex_tpu.training import data as jdata
from poreplex_tpu.training import scaler_workflow as jscaler_workflow
from poreplex_tpu.training import workflow as jworkflow
from poreplex_torch.config import load_preset
from poreplex_torch.models.demux import DemuxModel
from poreplex_torch.training import data, scaler_workflow, workflow

from test_torch_commandline import SCALED_RTOL, reduced_presets
from test_torch_training import (MODEL_ATOL, assert_demux_models_agree,
                                 assert_scaler_models_agree)

# a window is its dumped signal's last 300 frames over their median and
# MAD, so the scaled frames' SCALED_RTOL becomes this
WINDOW_ATOL = 1e-4
quiet = lambda *args: None


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads in this module: the suite runs several workers
    on the host's cores, and torch's spinning thread pools slow every
    process on the host when they oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------- demux

@pytest.fixture(scope='module')
def demux_workflows(tmp_path_factory):
    """Both packages' run_workflow over the same two barcoded runs."""
    base = tmp_path_factory.mktemp('demux-workflow')
    jax_preset, torch_preset = reduced_presets(base)
    runs = []
    for bc in range(2):
        rundir = str(base / 'run-bc{}'.format(bc + 1))
        make_fixture_dir(rundir, n_reads=8, seed=50 + bc, barcode=bc,
                         transcript_len=3000, polya_len=1200,
                         adapter_len=5200)
        runs.append(('BC{}'.format(bc + 1), rundir))
    out = {'runs': runs, 'base': base, 'jax': str(base / 'jax'),
           'torch': str(base / 'torch'), 'logs': []}
    out['jax_acc'] = jworkflow.run_workflow(
        runs, out['jax'], steps=2, seed=3, log=quiet,
        config_overrides={'preset': jax_preset})
    out['torch_acc'] = workflow.run_workflow(
        runs, out['torch'], steps=2, seed=3, log=out['logs'].append,
        config_overrides={'preset': torch_preset}, device='cpu')
    out['torch_preset'] = torch_preset
    return out


def inventory(outdir, label):
    return os.path.join(outdir, 'prepare', label, workflow.INVENTORY_RELPATH)


def test_prepared_inventories_hold_equal_windows(demux_workflows):
    import h5py
    for label, _ in demux_workflows['runs']:
        paths = [inventory(demux_workflows[p], label)
                 for p in ('torch', 'jax')]
        signals = []
        for path in paths:
            with h5py.File(path, 'r') as h5:
                signals.append({rid: grp[rid][:] for grp in
                                h5['adapter'].values() for rid in grp})
        got, want = signals
        assert len(want) >= 6 and sorted(got) == sorted(want)
        for rid, signal in want.items():
            assert got[rid].shape == signal.shape, rid
            np.testing.assert_array_less(
                np.abs(got[rid] - signal),
                SCALED_RTOL * np.maximum(1.0, np.abs(signal)) + 1e-30)
        wt, ids_t = data.load_adapter_windows(paths[0])
        wj, ids_j = jdata.load_adapter_windows(paths[1])
        assert ids_t == ids_j
        np.testing.assert_allclose(wt, wj, rtol=0, atol=WINDOW_ATOL)


class Hit:
    def __init__(self, matched):
        self.cigar_str = '{}M'.format(matched)


def test_contamination_filter_equals_jax(demux_workflows):
    """tests/test_training.py's fake per-reference aligners: every read
    maps to its own run's reference, but one read a run maps better to the
    other one. Both packages' filters, each over its own prepared runs,
    keep the same reads and write the same tables."""
    runs = demux_workflows['runs']
    home, contaminated = {}, set()
    for label, _ in runs:
        pairs = list(workflow._read_fastq_sequences(
            os.path.join(demux_workflows['torch'], 'prepare', label)))
        assert pairs == list(jworkflow._read_fastq_sequences(
            os.path.join(demux_workflows['jax'], 'prepare', label)))
        home.update((seq, label) for _, seq in pairs)
        contaminated.add(pairs[0][1])

    class FakeRefAligner:
        def __init__(self, reference):
            self.label = os.path.basename(reference).split('.')[0]

        def map(self, seq):
            if seq in contaminated:
                yield Hit(900 if self.label != home[seq] else 100)
            elif self.label == home[seq]:
                yield Hit(800)

    refs = {label: str(demux_workflows['base'] / (label + '.fa'))
            for label, _ in runs}
    kept, tables = [], []
    for package, filter_reads in (('torch', workflow),
                                  ('jax', jworkflow)):
        prepare_dirs = {label: os.path.join(demux_workflows[package],
                                            'prepare', label)
                        for label, _ in runs}
        outdir = str(demux_workflows['base'] / ('filter-' + package))
        kept.append(filter_reads.filter_contaminated_reads(
            prepare_dirs, refs, outdir, make_aligner=FakeRefAligner,
            log=quiet))
        tables.append({label: open(os.path.join(
            outdir, 'tables', 'alignment-scores-{}.tsv'.format(label)),
            'rb').read() for label, _ in runs})
    assert kept[0] == kept[1]
    assert all(len(kept[0][label]) == 7 for label, _ in runs)
    assert tables[0] == tables[1]


def test_evaluate_of_a_jax_checkpoint_equals_jax(demux_workflows):
    """JAX's two-step checkpoint evaluated by both packages, on the
    workflow's data and on 100 synthetic windows: the serving models'
    probabilities within MODEL_ATOL, and the same evaluation.txt. A
    window whose argmax differs must be a tie within 2 * MODEL_ATOL (the
    assertion names it), and then only the counts must agree."""
    import jax.numpy as jnp
    from poreplex_tpu.models.demux import DemuxModel as JaxDemuxModel
    runs = demux_workflows['runs']
    model_path = os.path.join(demux_workflows['jax'], 'demux-model.npz')
    workflow_data = jdata.dumps_dataset(
        [(inventory(demux_workflows['jax'], label),
          jworkflow.LABEL_IDS[label]) for label, _ in runs],
        rng=np.random.RandomState(3))
    synthetic = data.demux_dataset(20, np.random.RandomState(7))
    base = demux_workflows['base']
    for name, windows_labels in (('workflow', workflow_data),
                                 ('synthetic', synthetic)):
        paths = [str(base / '{}-{}.txt'.format(name, p))
                 for p in ('torch', 'jax')]
        workflow.evaluate(model_path, windows_labels, paths[0], log=quiet,
                          device='cpu')
        jworkflow.evaluate(model_path, windows_labels, paths[1], log=quiet)
        windows = windows_labels[0][:int(len(windows_labels[0]) * 0.25)]
        with torch.no_grad():
            got = DemuxModel(model_path, device='cpu')(
                torch.as_tensor(windows)).numpy()
        want = np.asarray(JaxDemuxModel(model_path)._apply(
            jnp.asarray(windows)))
        np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_ATOL)
        top2 = np.sort(want, axis=1)[:, -2:]
        flipped = [(name, i, float(top2[i, 1] - top2[i, 0])) for i in
                   np.nonzero(got.argmax(1) != want.argmax(1))[0]]
        assert all(margin <= 2 * MODEL_ATOL for *_, margin in flipped), \
            flipped
        texts = [open(p).read().splitlines() for p in paths]
        assert texts[0][0].startswith('accuracy\t')
        if flipped:
            assert texts[0][2] == texts[1][2], flipped
        else:
            assert texts[0] == texts[1], name


def test_second_run_reuses_every_stage(demux_workflows):
    logs = []
    acc = workflow.run_workflow(
        demux_workflows['runs'], demux_workflows['torch'], steps=2, seed=3,
        log=logs.append,
        config_overrides={'preset': demux_workflows['torch_preset']},
        device='cpu')
    assert acc == demux_workflows['torch_acc']
    assert len(logs) == 4
    assert all('up to date' in line for line in logs)
    assert any(line.startswith('step    1 loss')
               for line in demux_workflows['logs'])


def test_demux_workflow_checkpoint_loads_in_both_packages(demux_workflows):
    windows, _ = data.demux_dataset(2, np.random.RandomState(31))
    assert_demux_models_agree(
        os.path.join(demux_workflows['torch'], 'demux-model.npz'),
        windows[:6])


# ---------------------------------------------------------------- scaler

@pytest.fixture(scope='module')
def kmer_model():
    return load_preset()['kmer_model']


def test_kmer_levels_equal_pandas(kmer_model):
    import pandas as pd
    table = pd.read_csv(kmer_model, header=0, index_col=0, sep='\t')
    want = table['level_mean'].to_dict()
    got = scaler_workflow.read_kmer_levels(kmer_model)
    assert list(got) == list(want) and len(got) == 1024
    assert got == want


@pytest.fixture(scope='module')
def scaler_workflows(tmp_path_factory, kmer_model):
    """Both packages' run_workflow over the same two basecalled runs."""
    import h5py
    base = tmp_path_factory.mktemp('scaler-workflow')
    levels = scaler_workflow.read_kmer_levels(kmer_model)
    rng = np.random.RandomState(9)
    runs = []
    for r in range(2):
        rundir = str(base / 'run{}'.format(r))
        make_fixture_dir(rundir, n_reads=10, seed=90 + r,
                         transcript_len=3000, polya_len=1200,
                         adapter_len=5200)
        for fn in sorted(os.listdir(rundir)):
            with h5py.File(os.path.join(rundir, fn), 'r+') as f5:
                for node in [n for n in f5 if n.startswith('read_')]:
                    scale = rng.uniform(0.85, 1.15)
                    shift = rng.uniform(-8, 8)
                    dsname = ('{}/Analyses/Basecall_1D_000/'
                              'BaseCalled_template/Events'.format(node))
                    ev = f5[dsname][()]
                    lv = np.asarray([levels.get(s.decode(), 92.0)
                                     for s in ev['model_state']])
                    ev['mean'] = ((lv - shift) / scale +
                                  rng.normal(0, 0.05, len(lv)))
                    del f5[dsname]
                    f5.create_dataset(dsname, data=ev)
        runs.append(rundir)
    out = {'runs': runs, 'base': base, 'jax': str(base / 'jax'),
           'torch': str(base / 'torch'), 'logs': []}
    with np.errstate(divide='ignore', invalid='ignore'):
        out['jax_lines'] = jscaler_workflow.run_workflow(
            runs, out['jax'], kmer_model, steps=1, log=quiet)
        out['torch_lines'] = scaler_workflow.run_workflow(
            runs, out['torch'], kmer_model, steps=1,
            log=out['logs'].append, device='cpu')
    return out


def test_extract_purify_split_equal_jax(scaler_workflows):
    arrays = {}
    for package in ('torch', 'jax'):
        adir = os.path.join(scaler_workflows[package], 'dataarrays')
        arrays[package] = {name: np.load(os.path.join(adir, name))
                           for name in sorted(os.listdir(adir))}
    assert list(arrays['torch']) == list(arrays['jax'])
    assert len(arrays['torch']) == 4
    for name, value in arrays['jax'].items():
        assert arrays['torch'][name].dtype == value.dtype, name
        np.testing.assert_array_equal(arrays['torch'][name], value, name)
    with open(os.path.join(scaler_workflows['torch'],
                           'scaling-transform.json')) as f:
        transform = f.read()
    with open(os.path.join(scaler_workflows['jax'],
                           'scaling-transform.json')) as f:
        assert transform == f.read()

    signals = np.concatenate([arrays['jax']['signals-run0.npy'],
                              arrays['jax']['signals-run1.npy']])
    targets = np.concatenate([arrays['jax']['scaling-run0.npy'],
                              arrays['jax']['scaling-run1.npy']])
    assert len(signals) >= 8
    # purify needs 20 rows: the extracted ones and synthetic outliers
    rng = np.random.RandomState(4)
    many = np.concatenate([targets, np.column_stack([
        rng.normal(1.0, 0.05, 40), rng.normal(0.0, 4.0, 40)]),
        [[3.0, 40.0], [0.1, -60.0]]])
    many_signals = np.repeat(signals[:1], len(many), 0) + \
        np.arange(len(many), dtype=np.float32)[:, None]
    for sig, tgt in ((signals, targets), (many_signals, many)):
        got = scaler_workflow.purify(sig, tgt)
        want = jscaler_workflow.purify(sig, tgt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(want[1]) < len(many)
    got = scaler_workflow.split_and_redisperse(
        signals, targets, np.random.RandomState(922))
    want = jscaler_workflow.split_and_redisperse(
        signals, targets, np.random.RandomState(922))
    assert got[2] == want[2]
    for part in (0, 1):
        for a, b in zip(got[part], want[part]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_scaler_evaluate_of_a_jax_checkpoint_equals_jax(scaler_workflows):
    """JAX's one-step checkpoint evaluated by both packages on every
    extracted read: the same evaluation.txt."""
    adir = os.path.join(scaler_workflows['jax'], 'dataarrays')
    signals = np.concatenate([np.load(os.path.join(adir, name)) for name in
                              ('signals-run0.npy', 'signals-run1.npy')])
    targets = np.concatenate([np.load(os.path.join(adir, name)) for name in
                              ('scaling-run0.npy', 'scaling-run1.npy')])
    model_path = os.path.join(scaler_workflows['jax'], 'scaler-model.npz')
    paths = [str(scaler_workflows['base'] / 'eval-{}.txt'.format(p))
             for p in ('torch', 'jax')]
    lines = scaler_workflow.evaluate(model_path, signals, targets, paths[0],
                                     log=quiet, device='cpu')
    assert lines == jscaler_workflow.evaluate(model_path, signals, targets,
                                              paths[1], log=quiet)
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1]
    assert 'pearson_r\tscale\t' in texts[0]


def test_second_scaler_run_reuses_every_stage(scaler_workflows,
                                              kmer_model):
    logs = []
    lines = scaler_workflow.run_workflow(
        scaler_workflows['runs'], scaler_workflows['torch'], kmer_model,
        steps=1, log=logs.append, device='cpu')
    assert lines == scaler_workflows['torch_lines']
    assert len(logs) == 4
    assert all('up to date' in line for line in logs)
    assert any(line.startswith('step    0 loss')
               for line in scaler_workflows['logs'])


def test_scaler_workflow_checkpoint_loads_in_both_packages(
        scaler_workflows):
    heads, _ = data.scaler_dataset(4, np.random.RandomState(5),
                                   pooled_length=60)
    assert_scaler_models_agree(
        os.path.join(scaler_workflows['torch'], 'scaler-model.npz'), heads)


def test_workflows_want_cuda_by_default(tmp_path):
    """The workflows' entry points run on the card unless --cpu is given:
    without a card they stop before the first stage."""
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        workflow.main(['--run', 'BC1=' + str(tmp_path), '-o',
                       str(tmp_path / 'out'), '--steps', '1'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        scaler_workflow.main(['--run', str(tmp_path), '-o',
                              str(tmp_path / 'scaler'), '--steps', '1'])
    assert sorted(os.listdir(tmp_path)) == []
