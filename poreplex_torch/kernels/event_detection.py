"""Wrapper of the dual peak-detector kernel (``csrc/event_detection.cu``).

Same signature and results as ``ops.event_detection.detect_peaks``, which
runs for CPU tensors: (peaks_short [B, T], peaks_long [B, T]) int32, the
emitted peak position or -1 at each frame.
"""

import ctypes

import torch

from . import count, _build
from ..ops import event_detection as ed_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'pp_detect_peaks': [_P] * 5 + [_I, _I, _F, _F, _I, _I, _F, _P],
    'pp_peaks_launch_shape': [_I, _P],
}


def _lib():
    return _build.library('event_detection.cu', _SIGNATURES)


def launch_shape(batch):
    """(reads per block, threads per block, blocks) of the kernel for
    ``batch`` reads."""
    shape = (ctypes.c_int * 3)()
    _build.check(_lib().pp_peaks_launch_shape(batch, ctypes.addressof(shape)),
                 'detect_peaks')
    return tuple(shape)


def detect_peaks(tstat1, tstat2, lengths, threshold1, threshold2,
                 window_length1, window_length2, peak_height):
    """tstat1, tstat2 [B, T] float32 t-statistic streams of the short and
    long windows; lengths [B]."""
    if tstat1.device.type == 'cpu':
        return ed_ops.detect_peaks(tstat1, tstat2, lengths, threshold1,
                                   threshold2, window_length1,
                                   window_length2, peak_height)
    if (tstat1.dim() != 2 or tstat1.shape != tstat2.shape or
            tstat1.dtype != torch.float32 or tstat2.dtype != torch.float32):
        raise ValueError('detect_peaks: t-statistics must be two float32 '
                         '[B, T] tensors')
    batch, seqlen = tstat1.shape
    if tuple(lengths.shape) != (batch,):
        raise ValueError('detect_peaks: lengths must be [B]')
    if batch == 0 or seqlen == 0:
        raise ValueError('detect_peaks: empty batch or sequence')
    t1 = tstat1.contiguous()
    t2 = tstat2.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    em_s = torch.empty((batch, seqlen), dtype=torch.int32,
                       device=tstat1.device)
    em_l = torch.empty_like(em_s)
    _build.require_cuda('detect_peaks', t1, t2, lens, em_s, em_l)
    p = _build.ptr
    with _build.device_guard(t1):
        code = _lib().pp_detect_peaks(
            p(t1), p(t2), p(lens), p(em_s), p(em_l), batch, seqlen,
            float(threshold1), float(threshold2), int(window_length1),
            int(window_length2), float(peak_height),
            _build.stream(t1.device))
    _build.check(code, 'detect_peaks')
    count('detect_peaks', 'peaks_kernel')
    return em_s, em_l
