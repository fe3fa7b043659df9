"""poreplex_torch stands alone: it imports neither jax nor any module of
poreplex_tpu, its kernel wrappers never fall back to the plain version on a
device that is not the CPU, and asking for CUDA where there is none
raises."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / 'poreplex_torch'
FORBIDDEN = ('jax', 'jaxlib', 'optax', 'poreplex_tpu')


def port_modules():
    for path in sorted(PACKAGE.rglob('*.py')):
        rel = path.relative_to(REPO).with_suffix('')
        parts = rel.parts[:-1] if rel.name == '__init__' else rel.parts
        yield '.'.join(parts)


def port_sources():
    return sorted(PACKAGE.rglob('*.py')) + [REPO / 'chip_smoke.py',
                                            REPO / 'kernel_sass.py']


def loaded_after_importing_the_port(packages, missing=()):
    """The modules of ``packages`` loaded once every module of the port is
    imported, in a fresh interpreter where the packages ``missing`` cannot
    be imported."""
    code = ('import importlib, sys\n'
            'sys.modules.update(dict.fromkeys({!r}))\n'
            'for name in sys.argv[1:]:\n'
            '    importlib.import_module(name)\n'
            'bad = sorted(m for m, module in sys.modules.items()\n'
            '             if module and m.split(".")[0] in {!r})\n'
            'print(" ".join(bad))\n').format(missing, packages)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', code] + list(port_modules()),
                         capture_output=True, text=True, cwd=str(REPO),
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_importing_every_module_loads_no_jax():
    modules = set(port_modules())
    assert {'poreplex_torch.training.train_demux',
            'poreplex_torch.commandline', 'poreplex_torch.__main__',
            'poreplex_torch.pipeline.source', 'poreplex_torch.parallel',
            'poreplex_torch.parallel.mesh', 'poreplex_torch.parallel.sharding',
            'poreplex_torch.parallel.distributed',
            'poreplex_torch.parallel.training',
            'poreplex_torch.training.workflow',
            'poreplex_torch.training.scaler_workflow'} <= modules
    assert loaded_after_importing_the_port(FORBIDDEN) == ''


def test_importing_every_module_loads_no_h5py():
    """The card's machine has no h5py: the port imports it only inside the
    functions that open files, so every module imports without it."""
    assert loaded_after_importing_the_port(('h5py',)) == ''
    assert loaded_after_importing_the_port(('h5py',), missing=('h5py',)) \
        == ''


def test_sources_import_no_jax():
    """No import statement of the port or chip_smoke.py, at any level of
    the code, names jax or poreplex_tpu."""
    for path in port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split('.')[0] not in FORBIDDEN, (path, name)


def test_no_exception_handling_around_kernel_launches():
    """The wrappers and their callers on the stage-1 path hold no try
    statement, so a kernel failure can never turn into a silent fallback."""
    paths = (sorted((PACKAGE / 'kernels').glob('*.py')) +
             sorted((PACKAGE / 'models').glob('*.py')) +
             sorted((PACKAGE / 'ops').glob('*.py')) +
             sorted((PACKAGE / 'parallel').glob('*.py')) +
             [PACKAGE / 'pipeline' / 'engine.py',
              PACKAGE / 'pipeline' / 'polya.py'])
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            assert not isinstance(node, ast.Try), path


def test_cuda_without_cuda_raises(tmp_path):
    from poreplex_torch.config import build_config
    from poreplex_torch.models.demux import DemuxModel
    from poreplex_torch.models.scaler import ScalerModel
    from poreplex_torch.models.segmentation import SegmentationHMM
    from poreplex_torch.pipeline.engine import DeviceEngine
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_config(str(tmp_path), str(tmp_path))
    config = build_config(str(tmp_path), str(tmp_path), device='cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        DeviceEngine(config, device='cuda')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        SegmentationHMM(config['segmentation_model'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ScalerModel(config['signal_processing']['scaler_model'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        DemuxModel(config['demultiplexing']['demux_model'])


def test_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU never takes the plain path: here a
    'meta' tensor, which no kernel takes, raises."""
    from poreplex_torch.kernels import (event_detection as ked,
                                        lstm as klstm, polya_dp as kdp,
                                        viterbi as kvit)
    meta = dict(device='meta', dtype=torch.float32)
    p = {'kernel': torch.empty(1, 192, **meta),
         'recurrent': torch.empty(48, 192, **meta),
         'bias': torch.empty(192, **meta)}
    p2 = {'kernel': torch.empty(48, 192, **meta),
          'recurrent': torch.empty(48, 192, **meta),
          'bias': torch.empty(192, **meta)}
    xs = torch.empty(2, 5, 1, **meta)
    with pytest.raises(ValueError, match='no kernel for device'):
        klstm.lstm2_stacked(p, p2, xs)
    with pytest.raises(ValueError, match='no kernel for device'):
        klstm.bidirectional_lstm(p, p, xs)
    with pytest.raises(ValueError, match='no kernel for device'):
        klstm.lstm_last(p, xs)
    x = torch.empty(2, 7, **meta)
    hmm = [torch.empty(6, **meta), torch.empty(6, 6, **meta)] + \
        [torch.empty(6, 2, **meta) for _ in range(3)]
    lens = torch.empty(2, dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='no kernel for device'):
        kvit.viterbi_extents(x, lens, *hmm)
    with pytest.raises(ValueError, match='no kernel for device'):
        kvit.viterbi(x, lens, *hmm)
    with pytest.raises(ValueError, match='no kernel for device'):
        ked.detect_peaks(x, x, lens, 3.0, 8.0, 7, 20, 4.0)
    with pytest.raises(ValueError, match='no kernel for device'):
        mask = torch.empty(2, 7, dtype=torch.bool, device='meta')
        kdp.dp(mask, mask, x, lens, 1.5, 110)


@pytest.mark.parametrize('option,value', [
    ('dashboard', True), ('albacore_onthefly', True),
    ('minimap2_index', 'ref.mmi')])
def test_host_stage_options_build(tmp_path, option, value):
    """The options of the host stages (dashboard, albacore, alignment)
    build on the CPU as given; on-the-fly basecalling loads every batch
    in the analyzer's process, as poreplex-tpu's does."""
    from poreplex_torch.config import build_config, ingest_process_count
    config = build_config(str(tmp_path), str(tmp_path), device='cpu',
                          parallel=4, **{option: value})
    assert config[option] == value and config['device'] == 'cpu'
    assert ingest_process_count(config) == (
        0 if option == 'albacore_onthefly' else 4)


@pytest.mark.parametrize('option', ['resume', 'live', 'fast5_output',
                                    'nanopolish_output',
                                    'dump_adapter_signals',
                                    'dump_basecalls'])
def test_ported_session_options_build(tmp_path, option):
    """The session options ported with the command line build on the CPU
    when asked and want CUDA by default."""
    from poreplex_torch.config import build_config
    config = build_config(str(tmp_path), str(tmp_path), device='cpu',
                          **{option: True})
    assert config[option] is True
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_config(str(tmp_path), str(tmp_path), **{option: True})


@pytest.mark.parametrize('option', ['measure_polya',
                                    'filter_unsplit_reads'])
def test_polya_and_unsplit_options_build(tmp_path, option):
    """Ported stages build on the CPU when asked and want CUDA by
    default."""
    from poreplex_torch.config import build_config
    config = build_config(str(tmp_path), str(tmp_path), device='cpu',
                          **{option: True})
    assert config[option] is True
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_config(str(tmp_path), str(tmp_path), **{option: True})


@pytest.mark.parametrize('option,value', [
    ('mesh_shape', 2), ('num_nodes', 2), ('node_rank', 1),
    ('coordinator', '127.0.0.1:29500')])
def test_parallel_options_build(tmp_path, option, value):
    """The options of the multi-GPU slice build on the CPU when asked and
    want CUDA by default."""
    from poreplex_torch.config import build_config
    config = build_config(str(tmp_path), str(tmp_path), device='cpu',
                          **{option: value})
    assert config[option] == value
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_config(str(tmp_path), str(tmp_path), **{option: value})


def test_tpu_knobs_are_unknown(tmp_path):
    from poreplex_torch.config import build_config
    for option in ('pallas', 'prewarm'):
        with pytest.raises(KeyError):
            build_config(str(tmp_path), str(tmp_path), device='cpu',
                         **{option: 'auto'})


def test_kernel_build_targets_hopper():
    from poreplex_torch.kernels import _build
    assert 'arch=compute_90a,code=sm_90a' in _build.FLAGS
    assert '--fmad=false' in _build.SOURCE_FLAGS['viterbi.cu']
    assert set(_build.SOURCES) == {p.name for p in
                                   (PACKAGE / 'csrc').glob('*.cu')}
    for source in _build.SOURCES:
        assert (PACKAGE / 'csrc' / source).is_file()
        path = _build.library_path(source)
        assert path.startswith(str(REPO / 'build' / 'poreplex_torch_kernels'))
