"""Wrapper of the segmentation Viterbi-with-extents kernel
(``csrc/viterbi.cu``).

Same signature and results as ``ops.viterbi.viterbi_extents``, which runs
for CPU tensors: (first [B, S], last [B, S], present [B, S], logp [B]),
extents of each state's last contiguous run, -1 where a state is absent.
"""

import ctypes

import torch

from . import launches, _build
from ..ops import viterbi as vit_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'pp_viterbi_extents': [_P] * 11 + [_I, _I, _I, _I, _P],
}
STATES = (6,)
COMPONENTS = (1, 2)


def _lib():
    return _build.library('viterbi.cu', _SIGNATURES)


def viterbi_extents(x, lengths, log_start, log_trans, mus, sigmas, logws):
    """x [B, T] float32 padded observations, lengths [B]; HMM parameters as
    in ops.viterbi. Returns (first, last, present, logp)."""
    if x.device.type == 'cpu':
        return vit_ops.viterbi_extents(x, lengths, log_start, log_trans, mus,
                                       sigmas, logws)
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError('viterbi_extents: x must be float32 [B, T]')
    batch, seqlen = x.shape
    nstates, ncomp = mus.shape
    if nstates not in STATES or ncomp not in COMPONENTS:
        raise ValueError('viterbi_extents: no kernel for {} states x {} '
                         'components'.format(nstates, ncomp))
    if (tuple(log_start.shape) != (nstates,) or
            tuple(log_trans.shape) != (nstates, nstates) or
            tuple(sigmas.shape) != (nstates, ncomp) or
            tuple(logws.shape) != (nstates, ncomp) or
            tuple(lengths.shape) != (batch,)):
        raise ValueError('viterbi_extents: parameter shapes do not match')
    if batch == 0 or seqlen == 0:
        raise ValueError('viterbi_extents: empty batch or sequence')
    for t in (log_start, log_trans, mus, sigmas, logws):
        if t.dtype != torch.float32:
            raise ValueError('viterbi_extents: parameters must be float32')

    xt = x.t().contiguous()                         # [T, B]: coalesced reads
    lens = lengths.to(torch.int32).contiguous()
    const = vit_ops.emission_const(sigmas, logws).contiguous()
    bp = torch.empty((seqlen, batch), dtype=torch.int32, device=x.device)
    first = torch.empty((batch, nstates), dtype=torch.int32, device=x.device)
    last = torch.empty_like(first)
    logp = torch.empty((batch,), dtype=torch.float32, device=x.device)
    _build.require_cuda('viterbi_extents', xt, lens, log_start, log_trans,
                        mus, sigmas, const, bp, first, last, logp)
    p = _build.ptr
    code = _lib().pp_viterbi_extents(
        p(xt), p(lens), p(log_start), p(log_trans), p(mus), p(sigmas),
        p(const), p(bp), p(first), p(last), p(logp), batch, seqlen, nstates,
        ncomp, _build.stream(x.device))
    _build.check(code, 'viterbi_extents')
    launches['viterbi_extents'] += 1
    first, last = first.to(torch.int64), last.to(torch.int64)
    return first, last, last >= 0, logp
