"""Wrappers of the Viterbi kernels (``csrc/viterbi.cu``).

Same signatures and results as the plain versions in ``ops/viterbi.py``,
which run for CPU tensors:

  viterbi_extents  (first [B, S], last [B, S], present [B, S], logp [B]),
                   extents of each state's last contiguous run, -1 where a
                   state is absent (the segmentation HMM of stage 1)
  viterbi          (path [B, T] int64, logp [B]), the decoded state of every
                   frame (the unsplit-read HMM's windows)

The kernels take HMMs of 1 to 8 states with any number of mixture
components; ``plan`` gives the instantiation an HMM runs on and its
launch. More states raise ``ValueError`` before any launch.
"""

import collections
import ctypes

import torch

from . import count, _build
from ..ops import viterbi as vit_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'pp_viterbi_extents': [_P] * 11 + [_I, _I, _I, _I, _P],
    'pp_viterbi_path': [_P] * 10 + [_I, _I, _I, _I, _P],
    'pp_viterbi_launch_shape': [_I, _I, _I, _P],
}
MAX_STATES = 8
# the kernels' instantiations: states (an HMM of fewer is padded with inert
# states), and components (any other count runs a loop over them, 0 here,
# with its parameters and a scratch in up to DYN_BYTES of dynamic shared
# memory)
PADDED_STATES = (6, 8)
UNROLLED_COMPONENTS = (1, 2, 3, 4)
DYN_BYTES = 192 * 1024
# a block: reads, threads (one chain warp and four worker warps); the
# shipped HMMs' instantiations (6 states, K 1 and 2) keep their design,
# every other one runs the general design (a worker lane a state)
READS = 2
THREADS = 160
WORKERS = THREADS - 32
SHIPPED = ((6, 1), (6, 2))
DESIGNS = ('shipped', 'general')

Plan = collections.namedtuple('Plan', 'states components design launch smem')


def plan(nstates, ncomp, batch):
    """The instantiation and launch of either kernel for an HMM of
    ``nstates`` states with ``ncomp`` components over ``batch`` reads:
    Plan(states it is padded to, components it is unrolled for (0: a loop
    over any count), design ('shipped' or 'general'), (reads per block,
    threads per block, blocks), dynamic shared memory bytes a block).
    Raises ValueError for a shape no kernel takes."""
    if not 1 <= nstates <= MAX_STATES:
        raise ValueError('no Viterbi kernel for {} states (1 to {})'.format(
            nstates, MAX_STATES))
    if ncomp < 1:
        raise ValueError('no Viterbi kernel for {} components'.format(ncomp))
    if batch < 1:
        raise ValueError('empty batch')
    states = min(s for s in PADDED_STATES if s >= nstates)
    components = ncomp if ncomp in UNROLLED_COMPONENTS else 0
    design = 'shipped' if (states, components) in SHIPPED else 'general'
    shared, keep = any_k(nstates, ncomp)
    smem = 4 * (shared + keep * WORKERS) if components == 0 else 0
    return Plan(states, components, design,
                (READS, THREADS, (batch + READS - 1) // READS), smem)


def any_k(nstates, ncomp):
    """The dynamic shared memory of a loop-over-K block: (floats of the
    real states' mu, sigma and constant, [nstates, ncomp] each, if they
    take at most half of DYN_BYTES, else 0 and the workers read them from
    device memory; the components of a frame each worker keeps in its
    scratch, as many as the rest holds up to ncomp: the others are
    computed again for the sum)."""
    mixture = 3 * nstates * ncomp
    shared = mixture if 4 * mixture <= DYN_BYTES // 2 else 0
    return shared, min(ncomp, (DYN_BYTES // 4 - shared) // WORKERS)


def function(kernel, pl):
    """The kernel function and instantiation of plan ``pl``:
    ``'viterbi_path_kernel<8,4>'``."""
    return '{}<{},{}>'.format(kernel, pl.states, pl.components)


def _lib():
    return _build.library('viterbi.cu', _SIGNATURES)


def launch_shape(batch, nstates, ncomp):
    """((reads per block, threads per block, blocks), dynamic shared
    memory bytes, design) of either kernel for ``batch`` reads of an HMM
    of ``nstates`` states and ``ncomp`` components, from the C side."""
    shape = (ctypes.c_int * 5)()
    _build.check(_lib().pp_viterbi_launch_shape(batch, nstates, ncomp,
                                                ctypes.addressof(shape)),
                 'viterbi')
    return tuple(shape[:3]), shape[3], DESIGNS[shape[4]]


def _inputs(name, x, lengths, log_start, log_trans, mus, sigmas, logws):
    """Checks the wrappers' inputs; returns the kernel's (x [B, T], int32
    lengths, emission constants, backpointer scratch [B, T])."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError('{}: x must be float32 [B, T]'.format(name))
    batch, seqlen = x.shape
    nstates, ncomp = mus.shape
    if batch == 0 or seqlen == 0:
        raise ValueError('{}: empty batch or sequence'.format(name))
    if not 1 <= nstates <= MAX_STATES or ncomp < 1:
        raise ValueError('{}: no kernel for {} states x {} components (1 to '
                         '{} states, 1 or more components)'.format(
                             name, nstates, ncomp, MAX_STATES))
    if (tuple(log_start.shape) != (nstates,) or
            tuple(log_trans.shape) != (nstates, nstates) or
            tuple(sigmas.shape) != (nstates, ncomp) or
            tuple(logws.shape) != (nstates, ncomp) or
            tuple(lengths.shape) != (batch,)):
        raise ValueError('{}: parameter shapes do not match'.format(name))
    for t in (log_start, log_trans, mus, sigmas, logws):
        if t.dtype != torch.float32:
            raise ValueError('{}: parameters must be float32'.format(name))
    return (x.contiguous(), lengths.to(torch.int32).contiguous(),
            vit_ops.emission_const(sigmas, logws).contiguous(),
            torch.empty((batch, seqlen), dtype=torch.int32, device=x.device))


def viterbi_extents(x, lengths, log_start, log_trans, mus, sigmas, logws):
    """x [B, T] float32 padded observations, lengths [B]; HMM parameters as
    in ops.viterbi. Returns (first, last, present, logp)."""
    if x.device.type == 'cpu':
        return vit_ops.viterbi_extents(x, lengths, log_start, log_trans, mus,
                                       sigmas, logws)
    xc, lens, const, bp = _inputs('viterbi_extents', x, lengths, log_start,
                                 log_trans, mus, sigmas, logws)
    batch, seqlen = x.shape
    nstates, ncomp = mus.shape
    first = torch.empty((batch, nstates), dtype=torch.int64, device=x.device)
    last = torch.empty_like(first)
    logp = torch.empty((batch,), dtype=torch.float32, device=x.device)
    _build.require_cuda('viterbi_extents', xc, lens, log_start, log_trans,
                        mus, sigmas, const, bp, first, last, logp)
    p = _build.ptr
    with _build.device_guard(xc):
        code = _lib().pp_viterbi_extents(
            p(xc), p(lens), p(log_start), p(log_trans), p(mus), p(sigmas),
            p(const), p(bp), p(first), p(last), p(logp), batch, seqlen,
            nstates, ncomp, _build.stream(x.device))
    _build.check(code, 'viterbi_extents')
    count('viterbi_extents', function('viterbi_extents_kernel',
                                      plan(nstates, ncomp, batch)))
    return first, last, last >= 0, logp


def viterbi(x, lengths, log_start, log_trans, mus, sigmas, logws):
    """x [B, T] float32 padded observations, lengths [B]. Returns (path
    [B, T] int64, logp [B]); path entries past a read's length repeat its
    final decoded state."""
    if x.device.type == 'cpu':
        return vit_ops.viterbi(x, lengths, log_start, log_trans, mus, sigmas,
                               logws)
    xc, lens, const, bp = _inputs('viterbi', x, lengths, log_start, log_trans,
                                 mus, sigmas, logws)
    batch, seqlen = x.shape
    nstates, ncomp = mus.shape
    path = torch.empty((batch, seqlen), dtype=torch.int64, device=x.device)
    logp = torch.empty((batch,), dtype=torch.float32, device=x.device)
    _build.require_cuda('viterbi', xc, lens, log_start, log_trans, mus,
                        sigmas, const, bp, path, logp)
    p = _build.ptr
    with _build.device_guard(xc):
        code = _lib().pp_viterbi_path(
            p(xc), p(lens), p(log_start), p(log_trans), p(mus), p(sigmas),
            p(const), p(bp), p(path), p(logp), batch, seqlen, nstates,
            ncomp, _build.stream(x.device))
    _build.check(code, 'viterbi')
    count('viterbi', function('viterbi_path_kernel',
                              plan(nstates, ncomp, batch)))
    return path, logp
