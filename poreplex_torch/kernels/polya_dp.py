"""Wrapper of the poly(A) interval DP kernel (``csrc/polya_dp.cu``).

Same signature and results as ``ops.polya_dp.dp_core``, which runs for CPU
tensors: (start, end, score) int32 [N].
"""

import ctypes

import torch

from . import launches, _build
from ..ops import polya_dp as dp_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'pp_polya_dp': [_P] * 6 + [_I, _I, ctypes.c_float, _I, _P],
}


def _lib():
    return _build.library('polya_dp.cu', _SIGNATURES)


def dp(is_polya, length, n_events, spike_weight, spike_tolerance):
    """is_polya [N, K] bool, length [N, K] float32, n_events [N]."""
    if is_polya.device.type == 'cpu':
        return dp_ops.dp_core(is_polya, length, n_events, spike_weight,
                              spike_tolerance)
    if (is_polya.dim() != 2 or is_polya.dtype != torch.bool or
            length.shape != is_polya.shape or
            length.dtype != torch.float32):
        raise ValueError('polya_dp: is_polya must be bool and length '
                         'float32, both [N, K]')
    rows, kmax = is_polya.shape
    if tuple(n_events.shape) != (rows,):
        raise ValueError('polya_dp: n_events must be [N]')
    if rows == 0 or kmax == 0:
        raise ValueError('polya_dp: empty input')
    isp = is_polya.t().to(torch.uint8).contiguous()      # [K, N]: coalesced
    lengths = length.t().contiguous()
    n = n_events.to(torch.int32).contiguous()
    start = torch.empty(rows, dtype=torch.int32, device=is_polya.device)
    end = torch.empty_like(start)
    score = torch.empty_like(start)
    _build.require_cuda('polya_dp', isp, lengths, n, start, end, score)
    p = _build.ptr
    code = _lib().pp_polya_dp(
        p(isp), p(lengths), p(n), p(start), p(end), p(score), rows, kmax,
        float(spike_weight), int(spike_tolerance),
        _build.stream(is_polya.device))
    _build.check(code, 'polya_dp')
    launches['polya_dp'] += 1
    return start, end, score
