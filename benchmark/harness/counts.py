"""Operations, bytes and the card's published peaks: the count functions
of the program's chip smoke test (``chip_smoke.py``), frozen here, and
the stage-1 work a read needs under them."""

# published peaks of an H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# gate math per hidden unit and step: three sigmoids, two expm1 tanhs and
# the cell update, counted as elementwise operations
GATE_OPS = 28
# per valid frame of one read: the two detectors' compares, selects and
# subtractions (about 20 each), and per column of one DP row the prefix,
# budget, packed minimum and argmax updates (about 25 int32 operations)
PEAK_FRAME_OPS = 40
DP_COLUMN_OPS = 25


def bound(flops, nbytes):
    """Least time (s) the card could take: the larger of operations over
    the fp32 peak and bytes over the memory rate."""
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def lstm_flops(batch, seqlen, inputs, hidden, matrices):
    """Per row and step: the input projection, ``matrices`` [H, 4H]
    products, the pre-activation adds and the gate math."""
    g = 4 * hidden
    return batch * seqlen * (2 * inputs * g + matrices * 2 * hidden * g +
                             matrices * g + hidden * GATE_OPS)


def viterbi_frame_ops(nstates, ncomp):
    """Per valid frame and read: emission (5 ops per component, then the
    shift, exps, sum and log per state) and the transition max with its
    first-occurrence compare and the score update."""
    return (nstates * ncomp * 5 + nstates * (4 + 3 * ncomp) +
            3 * nstates * nstates + nstates)


class Stage1Work:
    """The least work of stage 1 for one read, by network, from the
    preset's widths: ``ops`` and ``nbytes`` take the read's valid
    segmentation frames. The scaler runs over its whole head window and
    the demux networks over their whole window, whose padding is input."""

    def __init__(self, head_frames, scaler_hidden, seg_states, seg_comp,
                 demux_frames, demux_hidden, last_hidden, barcoding):
        h1, h2 = scaler_hidden
        self.scaler = (lstm_flops(1, head_frames, 1, h1, 1) +
                       lstm_flops(1, head_frames, h1, h2, 1))
        self.scaler_bytes = head_frames * 4 + h2 * 4
        self.seg_frame = viterbi_frame_ops(seg_states, seg_comp)
        self.seg_states = seg_states
        self.demux = (2 * lstm_flops(1, demux_frames, 1, demux_hidden, 1) +
                      lstm_flops(1, demux_frames, 2 * demux_hidden,
                                 last_hidden, 1)) if barcoding else 0
        self.demux_bytes = (demux_frames * 4 * 2 +
                            demux_frames * 2 * demux_hidden * 4 * 2 +
                            last_hidden * 4) if barcoding else 0

    def ops(self, frames):
        return self.scaler + frames * self.seg_frame + self.demux

    def least_seconds(self, frames):
        """Sum of each kernel's bound for this read."""
        seg_bytes = frames * 4 + 4 + self.seg_states * 17 + 4
        return (bound(self.scaler, self.scaler_bytes) +
                bound(frames * self.seg_frame, seg_bytes) +
                (bound(self.demux, self.demux_bytes) if self.demux else 0.0))
