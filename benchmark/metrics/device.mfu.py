"""Device: the operations the scaler, segmentation HMM and demux networks
need for the reads completed in the window (harness/counts.py), over the
window's seconds times the card's 67 TFLOP/s fp32 peak, in percent."""


def read(run):
    if not run.completed_frames or run.window_s <= 0:
        return None
    ops = sum(run.work.ops(f) for f in run.completed_frames)
    return 100.0 * ops / (run.window_s * run.peak_fp32)
