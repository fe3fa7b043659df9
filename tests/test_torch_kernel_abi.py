"""The ctypes bindings of poreplex_torch's CUDA kernels match their sources:
every ``extern "C"`` function of each ``csrc/*.cu`` has an entry in its
wrapper's ``_SIGNATURES`` (wrapper ``kernels/<source name>.py``), with the
same number of arguments of the same kinds. A pointer must be declared
``c_void_p`` and an ``int`` ``c_int``: ctypes would otherwise pass a
pointer as a 32-bit int and cut it. The sources are parsed here; nvcc
never runs on the CPU. Each wrapper calls its C entry with its tensors'
device current (``_build.device_guard``), checked with a stub entry."""

import ctypes
import importlib
import pathlib
import re

import pytest

from poreplex_torch.kernels import _build

CSRC = pathlib.Path(_build.CSRC_DIR)
EXTERN_C = re.compile(r'extern "C" \{(.*?)\}\s*// extern "C"', re.S)
FUNCTION = re.compile(r'^int\s+(\w+)\s*\(([^)]*)\)\s*\{', re.M)
KINDS = {'int': ctypes.c_int, 'float': ctypes.c_float}


def argument_kind(declaration):
    """ctypes kind of one C parameter declaration."""
    if '*' in declaration:
        return ctypes.c_void_p
    words = declaration.replace('const', ' ').split()
    return KINDS[words[0]]


def exported(source):
    """{name: [ctypes kind of each argument]} of the source's extern "C"
    functions."""
    text = (CSRC / source).read_text()
    blocks = EXTERN_C.findall(text)
    assert blocks, '{} has no extern "C" block'.format(source)
    functions = {}
    for block in blocks:
        for name, params in FUNCTION.findall(block):
            functions[name] = [argument_kind(p) for p in params.split(',')
                               if p.strip()]
    return functions


@pytest.mark.parametrize('source', _build.SOURCES)
def test_signatures_match_extern_c(source):
    wrapper = importlib.import_module(
        'poreplex_torch.kernels.' + pathlib.Path(source).stem)
    functions = exported(source)
    assert functions, source
    assert set(wrapper._SIGNATURES) == set(functions)
    for name, kinds in functions.items():
        assert list(wrapper._SIGNATURES[name]) == kinds, name



# ------------------------------------------------------------ device guard

def _meta_calls():
    """(wrapper name, call) of each of the seven wrappers on 'meta'
    tensors, which take the kernel path (a wrapper runs its plain version
    for CPU tensors only)."""
    import torch
    from poreplex_torch.kernels import (event_detection as ked,
                                        lstm as klstm, polya_dp as kdp,
                                        viterbi as kvit)
    meta = dict(device='meta', dtype=torch.float32)

    def layer(inputs, hidden):
        return {'kernel': torch.empty(inputs, 4 * hidden, **meta),
                'recurrent': torch.empty(hidden, 4 * hidden, **meta),
                'bias': torch.empty(4 * hidden, **meta)}
    xs = torch.empty(2, 5, 1, **meta)
    x = torch.empty(2, 7, **meta)
    lens = torch.empty(2, dtype=torch.int32, device='meta')
    hmm = [torch.empty(6, **meta), torch.empty(6, 6, **meta)] + \
        [torch.empty(6, 2, **meta) for _ in range(3)]
    mask = torch.empty(2, 7, dtype=torch.bool, device='meta')
    return {
        'lstm2_stacked': lambda: klstm.lstm2_stacked(
            layer(1, 48), layer(48, 48), xs),
        'bidirectional_lstm': lambda: klstm.bidirectional_lstm(
            layer(1, 48), layer(1, 48), xs),
        'lstm_last': lambda: klstm.lstm_last(
            layer(96, 64), torch.empty(2, 5, 96, **meta)),
        'viterbi_extents': lambda: kvit.viterbi_extents(x, lens, *hmm),
        'viterbi': lambda: kvit.viterbi(x, lens, *hmm),
        'detect_peaks': lambda: ked.detect_peaks(x, x, lens, 3.0, 8.0, 7,
                                                 20, 4.0),
        'polya_dp': lambda: kdp.dp(mask, mask, x, lens, 1.5, 110),
    }


@pytest.mark.parametrize('name', ['lstm2_stacked', 'bidirectional_lstm',
                                  'lstm_last', 'viterbi_extents', 'viterbi',
                                  'detect_peaks', 'polya_dp'])
def test_wrapper_launches_on_its_tensors_device(monkeypatch, name):
    """The C entry (a stub here) runs with the device of the wrapper's
    tensors current, entered through torch.cuda.device, and the caller's
    current device is back afterwards: a launch on cuda:1 while cuda:0 is
    current sets its kernel's attributes and launches on cuda:1."""
    import torch
    from poreplex_torch import kernels
    current = ['cuda:0']
    seen = []

    class Device:
        def __init__(self, device):
            self.device = str(device)

        def __enter__(self):
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    class Library:
        def __getattr__(self, entry):
            def launch(*args):
                seen.append((entry, torch.cuda.current_device()))
                return 0
            return launch

    monkeypatch.setattr(torch.cuda, 'device', Device)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: current[0])
    monkeypatch.setattr(_build, 'library', lambda *args: Library())
    monkeypatch.setattr(_build, 'stream', lambda device: None)
    monkeypatch.setattr(_build, 'require_cuda', lambda *args: None)
    before = kernels.launches[name]
    _meta_calls()[name]()
    assert [device for _, device in seen] == ['meta']
    assert seen[0][0].startswith('pp_')
    assert current == ['cuda:0']
    assert kernels.launches[name] == before + 1
    kernels.launches[name] = before
