"""The ctypes bindings of poreplex_torch's CUDA kernels match their sources:
every ``extern "C"`` function of each ``csrc/*.cu`` has an entry in its
wrapper's ``_SIGNATURES`` (wrapper ``kernels/<source name>.py``), with the
same number of arguments of the same kinds. A pointer must be declared
``c_void_p`` and an ``int`` ``c_int``: ctypes would otherwise pass a
pointer as a 32-bit int and cut it. The sources are parsed here; nvcc
never runs on the CPU."""

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

