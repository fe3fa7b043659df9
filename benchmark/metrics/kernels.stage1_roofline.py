"""Kernels: stage 1's share of its roofline, in percent. The least time
the window's reads need of the scaler, segmentation and demux networks
(fp32 operations over 67 TFLOP/s or bytes over 3.35 TB/s, the larger, a
network and read at a time; harness/counts.py) over the device time of
the kernels that run them."""

STAGE1_KERNELS = ('lstm2_stacked', 'bilstm', 'lstm_last', 'lstm_general',
                  'viterbi_extents')


def read(run):
    if run.device_spans is None:
        return None
    device = sum(e - s for s, e, name in run.device_spans
                 if any(k in name for k in STAGE1_KERNELS))
    if device <= 0:
        return None
    least = sum(run.work.least_seconds(f) for f in run.stage1_frames)
    return 100.0 * least / device
