"""Wrappers of the Viterbi kernels (``csrc/viterbi.cu``).

Same signatures and results as the plain versions in ``ops/viterbi.py``,
which run for CPU tensors:

  viterbi_extents  (first [B, S], last [B, S], present [B, S], logp [B]),
                   extents of each state's last contiguous run, -1 where a
                   state is absent (the segmentation HMM of stage 1)
  viterbi          (path [B, T] int64, logp [B]), the decoded state of every
                   frame (the unsplit-read HMM's windows)

The kernels take HMMs of 1 to 8 states with any number of mixture
components, as the TPU kernels do; ``plan`` gives the instantiation an HMM
runs on. More than 8 states raise ``ValueError`` before any launch.
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
    'pp_viterbi_launch_shape': [_I, _P],
}
MAX_STATES = 8
# the kernels' instantiations: states (an HMM of fewer is padded with inert
# states), and components (any other count runs a loop over them, 0 here)
PADDED_STATES = (6, 8)
UNROLLED_COMPONENTS = (1, 2)
# a block: reads, threads (one chain warp and four worker warps)
READS = 2
THREADS = 160

Plan = collections.namedtuple('Plan', 'states components launch')


def plan(nstates, ncomp, batch):
    """The instantiation and launch of either kernel for an HMM of
    ``nstates`` states with ``ncomp`` components over ``batch`` reads:
    Plan(states it is padded to, components it is unrolled for (0: a loop
    over any count), (reads per block, threads per block, blocks)).
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
    return Plan(states, components,
                (READS, THREADS, (batch + READS - 1) // READS))


def _lib():
    return _build.library('viterbi.cu', _SIGNATURES)


def launch_shape(batch):
    """(reads per block, threads per block, blocks) of either kernel for
    ``batch`` reads."""
    shape = (ctypes.c_int * 3)()
    _build.check(_lib().pp_viterbi_launch_shape(batch,
                                                ctypes.addressof(shape)),
                 'viterbi')
    return tuple(shape)


def _function(kernel, mus):
    """The kernel function and instantiation that runs an HMM of mus'
    [S, K]."""
    pl = plan(mus.shape[0], mus.shape[1], 1)
    return '{}<{},{}>'.format(kernel, pl.states, pl.components)


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
                         '{} states)'.format(name, nstates, ncomp,
                                             MAX_STATES))
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
    count('viterbi_extents', _function('viterbi_extents_kernel', mus))
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
    count('viterbi', _function('viterbi_path_kernel', mus))
    return path, logp
