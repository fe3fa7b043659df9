"""Barcode demultiplexer network: the last 300 pooled frames of the
adapter, med/MAD-normalized -> BiLSTM -> LSTM -> Dense(5) -> softmax;
label = argmax - decoys, with a calibrated phred score from a lookup table
and a threshold gate. Weights come from ``demux-tetra-r4.npz`` (BiLSTM(48),
LSTM(64)) or any bundle of that layout, at the widths it holds."""

import numpy as np
import torch
from torch import nn

from .. import weights
from ..config import resolve_device
from ..kernels import lstm as lstm_kernels
from ..ops import rnn

PAD_FILLER = -1000.0   # left-pad filler for short adapters


class DemuxModel(nn.Module):

    def __init__(self, model_path, number_of_decoy_labels=1, device='cuda'):
        super().__init__()
        data = np.load(model_path)
        weights.parameter_dicts(self, weights.demux_state_dict(data),
                                weights.DEMUX_LAYERS)
        # phred -> minimum softmax score
        self.calibration_table = np.asarray(data['calibration'], np.float64)
        self.loss_weights = np.asarray(data['loss_weights'])
        self.number_of_decoy_labels = int(number_of_decoy_labels)
        self.to(resolve_device(device))

    def score_threshold(self, quality_threshold):
        """Minimum softmax score for a phred-scale quality threshold."""
        if len(self.calibration_table) - 1 < quality_threshold:
            raise ValueError(
                'The current demultiplexer does not support calibrated score '
                'of {}. Consider lowering --barcoding-quality-filter value.'
                .format(quality_threshold))
        return float(self.calibration_table[quality_threshold])

    def lookup_calibrated_phred_score(self, score):
        """bisect_right over the calibration table."""
        if score <= 0.0:
            return 0
        return int(np.searchsorted(self.calibration_table, score,
                                   side='right'))

    def forward(self, signals):
        """signals [B, T] normalized adapter windows -> probs [B, 5]."""
        h = lstm_kernels.bidirectional_lstm(self.bilstm_fwd, self.bilstm_bwd,
                                            signals[..., None])
        h = lstm_kernels.lstm_last(self.lstm2, h)
        return torch.softmax(rnn.dense(self.dense, h), dim=-1)

    @torch.inference_mode()
    def predict(self, signals):
        """(best label - decoys, best score) per read, as numpy."""
        device = self.dense['bias'].device
        probs = self(torch.as_tensor(np.asarray(signals, np.float32),
                                     device=device)).cpu().numpy()
        return (probs.argmax(axis=1) - self.number_of_decoy_labels,
                probs.max(axis=1))
