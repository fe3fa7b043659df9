"""Per-read record with upstream poreplex's status lattice and report
format. Host-side state only; the signal math runs in the batched device
stage."""

import os

import numpy as np


class ReadRecord:

    def __init__(self, filename, srcdir, read_id):
        self.fullpath = os.path.join(srcdir, filename)
        self.filename = filename
        self.read_id = read_id
        self.status = 'okay'
        self.stopped = False
        self.error_message = None

        self.sampling_rate = None
        self.duration = 0
        self.channel = None
        self.start_time_s = None
        self.run_id = None
        self.sample_id = None

        self.scaling_params = None       # (scale, shift)
        self.label = None
        self.barcode = None
        self.barcode_bestguess = None
        self.barcode_quality = None
        self.polya = None                # poly(A) tail dict
        self.sequence = None             # (seq, qual, adapter_trim_len)
        self.sequence_length = 0
        self.mean_qscore = 0
        self.num_events = 0

        # transient analysis state (cleared after the batch)
        self.raw_dac = None              # integer DAC signal (poly(A) on)
        self.raw_pa = None               # float32 pA signal of a wide DAC
        self.calib = (1.0, 0.0)          # (pa_scale, dac_offset)
        self.pooled = None               # stride-pooled pA signal
        self.head_len = 0                # scaler-head frames in pooled
        self.segments = None             # {state: (first, last)} pooled frames
        self.events = None               # EventTable of basecalled events
        self.bcall = None                # basecall dict read at ingest
        self.bcall_error = None          # deferred basecall read failure
        self.kept_read = None            # fast5.KeptRead for albacore

    # ---- status lattice ----
    def set_status(self, newstatus, stop=False):
        self.status = newstatus
        self.stopped = self.stopped or stop

    def set_error(self, status, error_message):
        self.status = status
        self.error_message = error_message

    def is_stopped(self):
        return self.stopped

    def set_scaling_params(self, params):
        self.scaling_params = params

    @property
    def signal_length(self):
        raw = self.raw_dac if self.raw_dac is not None else self.raw_pa
        return len(raw)

    def dac_window(self, begin, end):
        """The raw samples of [begin, end) and the affine (a, b) onto the
        SCALED pA signal: scaled = a * window + b. An integer DAC window is
        a view, with the pA conversion and the read's scaling folded into
        (a, b), so the poly(A) wire carries the integers losslessly."""
        scale, shift = self.scaling_params
        if self.raw_dac is not None:
            pa_scale, dac_offset = self.calib
            a = float(scale) * float(pa_scale)
            return (self.raw_dac[begin:end], np.float32(a),
                    np.float32(a * float(dac_offset) + float(shift)))
        return (self.raw_pa[begin:end], np.float32(scale),
                np.float32(shift))

    def set_label(self, newlabel):
        self.label = newlabel

    def set_barcode(self, newbarcode, guess, quality):
        self.barcode = newbarcode
        self.barcode_bestguess = guess
        self.barcode_quality = quality

    def set_adapter_trimming_length(self, newlength):
        if self.sequence is None:
            raise Exception('Sequence is not set.')
        self.sequence = self.sequence[:2] + (newlength,)

    def set_polya_tail(self, polya_info):
        self.polya = polya_info

    def clear_cache(self):
        self.raw_dac = None
        self.raw_pa = None
        self.pooled = None
        self.events = None
        self.bcall = None
        self.kept_read = None

    def report(self):
        """Result dict in upstream poreplex's format."""
        rep = {'filename': self.filename, 'read_id': self.read_id,
               'status': self.status}

        if self.sampling_rate is not None:
            rep.update({
                'channel': self.channel,
                'start_time': self.start_time_s,
                'run_id': self.run_id,
                'sample_id': self.sample_id,
                'duration': self.duration,
                'num_events': self.num_events,
                'sequence_length': self.sequence_length,
                'mean_qscore': self.mean_qscore,
            })

        if self.sequence is not None:
            rep['sequence'] = self.sequence
        if self.error_message:
            rep['error_message'] = self.error_message
        if self.label is not None:
            rep['label'] = self.label
        if self.barcode is not None:
            rep['barcode'] = self.barcode
            rep['barcode_guess'] = self.barcode_bestguess
            rep['barcode_score'] = self.barcode_quality
        if self.polya is not None:
            rep['polya'] = self.polya
        return rep
