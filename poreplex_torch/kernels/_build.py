"""Build ``csrc/*.cu`` with nvcc at first use and load them with ctypes.

Each source becomes one shared library with a plain C interface, compiled
for ``sm_90a`` into ``build/poreplex_torch_kernels/`` beside the package,
named by a hash of its source and flags so an edited source is rebuilt and
an unchanged one is reused. No PyTorch headers are included, which keeps a
build to seconds. Every C entry point returns ``cudaGetLastError()`` after
its launch; ``check`` turns a non-zero code into an exception. A C entry
configures and launches its kernel on the current CUDA device, so every
wrapper makes its tensors' card current around the call
(``device_guard``).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build',
                         'poreplex_torch_kernels')

SOURCES = ('lstm.cu', 'viterbi.cu', 'event_detection.cu', 'polya_dp.cu')
FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# the Viterbi's decisions are float comparisons held exactly against the
# plain version: no multiply-add contraction there
SOURCE_FLAGS = {'viterbi.cu': ['--fmad=false']}

_lock = threading.Lock()
_libraries = {}
# seconds each source's last nvcc run took
build_seconds = {}


def nvcc_path():
    candidates = [shutil.which('nvcc'),
                  os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                               'bin', 'nvcc')]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'source at first use and need the CUDA toolkit')


def flags(source):
    return FLAGS + SOURCE_FLAGS.get(source, [])


def library_path(source):
    with open(os.path.join(CSRC_DIR, source), 'rb') as f:
        text = f.read()
    key = hashlib.sha256(text + ' '.join(flags(source)).encode()
                         ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, '{}-{}.so'.format(
        os.path.splitext(source)[0], key))


def compile_source(source):
    """Compile one source unless its library exists; returns nvcc's
    resource report (``-Xptxas -v``), or '' when the library was reused."""
    target = library_path(source)
    if os.path.exists(target):
        return ''
    os.makedirs(BUILD_DIR, exist_ok=True)
    partial = '{}.{}.tmp'.format(target, os.getpid())
    command = ([nvcc_path()] + flags(source) +
               ['-o', partial, os.path.join(CSRC_DIR, source)])
    t0 = time.perf_counter()
    proc = subprocess.run(command, capture_output=True, text=True)
    build_seconds[source] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on {}:\n{}{}'.format(
            source, proc.stdout, proc.stderr))
    os.replace(partial, target)
    return proc.stdout + proc.stderr


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILLS = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                     r'(\d+) bytes spill loads')
_REGISTERS = re.compile(r'Used (\d+) registers')
_ARGS = re.compile(r'I((?:L[a-z]+\d+E)+)E')


def kernel_label(mangled):
    """'lstm2_stacked_kernel<48>' for a mangled kernel name: its last
    name (past its namespaces) and its integer or bool template
    arguments."""
    m = re.match(r'_ZN?', mangled)
    if not m:
        return mangled
    i, name = m.end(), None
    while True:
        n = re.match(r'\d+', mangled[i:])
        if not n:
            break
        i += len(n.group())
        name, i = mangled[i:i + int(n.group())], i + int(n.group())
    if name is None:
        return mangled
    args = _ARGS.match(mangled, i)
    if not args:
        return name
    return '{}<{}>'.format(name, ','.join(
        ('true' if v == '1' else 'false') if kind == 'b' else v
        for kind, v in re.findall(r'L([a-z]+)(\d+)E', args.group(1))))


def ptxas_usage(report):
    """{kernel label: (registers, stack bytes, spill store bytes, spill
    load bytes)} from nvcc's -Xptxas -v report."""
    usage, entry, spills = {}, None, (0, 0, 0)
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry, spills = kernel_label(m.group(1)), (0, 0, 0)
            continue
        m = _SPILLS.search(line)
        if m and entry:
            spills = tuple(int(v) for v in m.groups())
            continue
        m = _REGISTERS.search(line)
        if m and entry:
            usage[entry] = (int(m.group(1)),) + spills
            entry = None
    return usage


def usage_lines(source, report):
    """One line a kernel instantiation of ``source``: its registers, stack
    and spills from the -Xptxas -v report."""
    return ['{}: {}: {} registers, {} bytes stack, {} bytes spill stores, '
            '{} bytes spill loads'.format(source, label, *usage)
            for label, usage in sorted(ptxas_usage(report).items())]


def build_all():
    """Compile every source at once, one nvcc process each; returns
    {source: nvcc report}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        reports = list(pool.map(compile_source, SOURCES))
    return dict(zip(SOURCES, reports))


def library(source, signatures):
    """The loaded library of ``source``, built first if needed, with
    ``signatures`` = {function: argtypes} declared (restype int)."""
    with _lock:
        lib = _libraries.get(source)
        if lib is None:
            compile_source(source)
            lib = ctypes.CDLL(library_path(source))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libraries[source] = lib
        return lib


def check(code, name):
    if code != 0:
        raise RuntimeError('{} kernel launch failed: CUDA error {}'.format(
            name, code))


def ptr(tensor):
    """The address of a tensor's data for a kernel launch. The wrapper may
    drop the tensor before the kernel has run: PyTorch's caching allocator
    reuses the memory only for work queued later on the same stream."""
    return ctypes.c_void_p(tensor.data_ptr())


def device_guard(tensor):
    """Makes ``tensor``'s card the current CUDA device for the block: the
    C entry's cudaFuncSetAttribute, its launch on that card's stream and
    its cudaGetLastError all need the card that holds the tensors."""
    import torch
    return torch.cuda.device(tensor.device)


def stream(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name, *tensors):
    """The wrappers' input contract: float32 / int32 contiguous tensors on
    one CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError('{}: tensors on {} and {}'.format(
                name, device, t.device))
        if not t.is_contiguous():
            raise ValueError('{}: non-contiguous input'.format(name))
    if device.type != 'cuda':
        raise ValueError('{}: no kernel for device {}'.format(name, device))
