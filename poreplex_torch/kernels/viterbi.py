"""Wrappers of the Viterbi kernels (``csrc/viterbi.cu``).

Same signatures and results as the plain versions in ``ops/viterbi.py``,
which run for CPU tensors:

  viterbi_extents  (first [B, S], last [B, S], present [B, S], logp [B]),
                   extents of each state's last contiguous run, -1 where a
                   state is absent (the segmentation HMM of stage 1)
  viterbi          (path [B, T] int64, logp [B]), the decoded state of every
                   frame (the unsplit-read HMM's windows)
"""

import ctypes

import torch

from . import launches, _build
from ..ops import viterbi as vit_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'pp_viterbi_extents': [_P] * 11 + [_I, _I, _I, _I, _P],
    'pp_viterbi_path': [_P] * 10 + [_I, _I, _I, _I, _P],
    'pp_viterbi_launch_shape': [_I, _P],
}
STATES = (6,)
COMPONENTS = (1, 2)


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


def _inputs(name, x, lengths, log_start, log_trans, mus, sigmas, logws):
    """Checks the wrappers' inputs; returns the kernel's (x [B, T], int32
    lengths, emission constants, backpointer scratch [B, T])."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError('{}: x must be float32 [B, T]'.format(name))
    batch, seqlen = x.shape
    nstates, ncomp = mus.shape
    if nstates not in STATES or ncomp not in COMPONENTS:
        raise ValueError('{}: no kernel for {} states x {} components'
                         .format(name, nstates, ncomp))
    if (tuple(log_start.shape) != (nstates,) or
            tuple(log_trans.shape) != (nstates, nstates) or
            tuple(sigmas.shape) != (nstates, ncomp) or
            tuple(logws.shape) != (nstates, ncomp) or
            tuple(lengths.shape) != (batch,)):
        raise ValueError('{}: parameter shapes do not match'.format(name))
    if batch == 0 or seqlen == 0:
        raise ValueError('{}: empty batch or sequence'.format(name))
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
    launches['viterbi_extents'] += 1
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
    launches['viterbi'] += 1
    return path, logp
