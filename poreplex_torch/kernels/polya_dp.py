"""Wrapper of the poly(A) interval DP kernel (``csrc/polya_dp.cu``).

Same results as ``ops.polya_dp.dp_core``, which runs for CPU tensors:
(start, end, score) int32 [N]. A round's two decision packs share their
event lengths and counts, so one call takes both masks and returns [2N]
outputs, the rows of the first mask then those of the second.
"""

import ctypes

import torch

from . import count, _build
from ..ops import polya_dp as dp_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'pp_polya_dp': [_P] * 5 + [_I, _I, ctypes.c_float, _I, _P],
    'pp_polya_dp_launch_shape': [_I, _P],
}


def _lib():
    return _build.library('polya_dp.cu', _SIGNATURES)


def launch_shape(rows):
    """(rows per block, threads per block, blocks) of the kernel for
    ``rows`` rows (both packs counted)."""
    shape = (ctypes.c_int * 3)()
    _build.check(_lib().pp_polya_dp_launch_shape(rows,
                                                 ctypes.addressof(shape)),
                 'polya_dp')
    return tuple(shape)


def dp(is_polya_a, is_polya_b, length, n_events, spike_weight,
       spike_tolerance):
    """is_polya_a, is_polya_b [N, K] bool, length [N, K] float32, n_events
    [N]: the DP of both masks over the same lengths and counts in one
    launch, [2N] outputs, the rows of is_polya_a then of is_polya_b."""
    masks = (is_polya_a, is_polya_b)
    if is_polya_a.device.type == 'cpu':
        return dp_ops.dp_core(torch.cat(masks), torch.cat([length] * 2),
                              torch.cat([n_events] * 2), spike_weight,
                              spike_tolerance)
    if (any(m.dim() != 2 or m.dtype != torch.bool or
            m.shape != length.shape for m in masks) or
            length.dtype != torch.float32):
        raise ValueError('polya_dp: masks must be bool and length float32, '
                         'all [N, K]')
    rows, kmax = is_polya_a.shape
    if tuple(n_events.shape) != (rows,):
        raise ValueError('polya_dp: n_events must be [N]')
    if rows == 0 or kmax == 0:
        raise ValueError('polya_dp: empty input')
    isp_a, isp_b = (m.contiguous() for m in masks)
    lengths = length.contiguous()
    n = n_events.to(torch.int32).contiguous()
    out = torch.empty((3, 2 * rows), dtype=torch.int32,
                      device=is_polya_a.device)
    _build.require_cuda('polya_dp', isp_a, isp_b, lengths, n, out)
    p = _build.ptr
    with _build.device_guard(out):
        code = _lib().pp_polya_dp(
            p(isp_a), p(isp_b), p(lengths), p(n), p(out), rows, kmax,
            float(spike_weight), int(spike_tolerance),
            _build.stream(out.device))
    _build.check(code, 'polya_dp')
    count('polya_dp', 'dp_kernel')
    return out[0], out[1], out[2]
