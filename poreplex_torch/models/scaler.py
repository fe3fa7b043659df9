"""Signal scaling predictor: the stride-pooled head of a read -> LSTM ->
LSTM -> Dense(2), then an affine output transform and a Gaussian-quantile
QC gate. Weights come from ``scaler-r3.npz`` (two LSTM(48)) or any bundle
of that layout, at the widths it holds."""

import json

import numpy as np
import torch
from scipy.stats import norm
from torch import nn

from .. import weights
from ..config import resolve_device
from ..kernels import lstm as lstm_kernels
from ..ops import rnn


class ScalerModel(nn.Module):

    def __init__(self, model_path, qc_threshold=0.02, input_length=None,
                 device='cuda'):
        super().__init__()
        data = np.load(model_path)
        weights.parameter_dicts(self, weights.scaler_state_dict(data),
                                weights.SCALER_LAYERS)
        meta = json.loads(bytes(data['meta']).decode())
        # a shortened head window is for reduced-size test configurations;
        # its predictions differ from the full-length model's
        self.input_length = (int(input_length) if input_length
                             else int(meta['input']['length']))    # 30000
        self.input_stride = int(meta['input']['stride'])          # 15
        self.min_length = int(meta['input']['min_length'])        # 9000
        if input_length:
            if self.input_length % self.input_stride != 0:
                raise ValueError(
                    'scaler_input_length override ({}) must be a multiple '
                    'of the input stride ({})'.format(self.input_length,
                                                      self.input_stride))
            self.min_length = min(self.min_length, self.input_length)
        self.pooled_length = self.input_length // self.input_stride
        self.model_version = meta.get('model_version', '')

        xfrm = meta['output_transform']
        # poly1d([std, mean]) == std * x + mean
        self.xfrm = np.array([[xfrm['scale_std'], xfrm['scale_mean']],
                              [xfrm['shift_std'], xfrm['shift_mean']]],
                             dtype=np.float64)
        q = [qc_threshold, 1.0 - qc_threshold]
        self.qc_scale_range = norm.ppf(q, xfrm['scale_mean'],
                                       xfrm['scale_std'])
        self.qc_shift_range = norm.ppf(q, xfrm['shift_mean'],
                                       xfrm['shift_std'])
        self.register_buffer('ranges', torch.tensor(
            np.array([self.qc_scale_range, self.qc_shift_range]),
            dtype=torch.float32))
        self.register_buffer('xfrm_t', torch.tensor(self.xfrm,
                                                    dtype=torch.float32))
        self.to(resolve_device(device))

    def forward(self, signal_heads):
        """signal_heads [B, pooled_length] -> (scaling [B, 2], qc_ok [B])."""
        h = lstm_kernels.lstm2_stacked(self.lstm1, self.lstm2,
                                       signal_heads[..., None])
        pred = rnn.dense(self.dense, h)
        scaling = pred * self.xfrm_t[:, 0] + self.xfrm_t[:, 1]
        qc_ok = ((scaling >= self.ranges[:, 0]) &
                 (scaling <= self.ranges[:, 1])).all(dim=-1)
        return scaling, qc_ok

    @torch.inference_mode()
    def predict(self, signal_heads):
        """numpy in, numpy out, on the module's device."""
        device = self.ranges.device
        scaling, qc_ok = self(torch.as_tensor(
            np.asarray(signal_heads, np.float32), device=device))
        return scaling.cpu().numpy(), qc_ok.cpu().numpy()
