"""The HMMs of the preset (signal segmentation and unsplit-read
detection; 6 states each in the shipped one), built from their state lists
as dense log-domain arrays (``weights.hmm_arrays``). The CUDA kernels take
1 to 8 states with any number of mixture components."""

import numpy as np
import torch
from torch import nn

from .. import weights
from ..config import resolve_device
from ..kernels import viterbi as vit_kernel
from ..ops import viterbi as vit_ops


class SegmentationHMM(nn.Module):

    def __init__(self, spec, device='cuda'):
        super().__init__()
        self.state_names = [s['name'] for s in spec]
        self.state_index = {n: i for i, n in enumerate(self.state_names)}
        self.nstates = len(spec)
        for key, value in weights.hmm_state_dict(
                weights.hmm_arrays(spec)).items():
            self.register_buffer(key, value)
        self.to(resolve_device(device))

    def params(self):
        return (self.log_start, self.log_trans, self.mus, self.sigmas,
                self.logws)

    def extents(self, x, lengths):
        """Segment extents (first, last, present, logp) through the
        Viterbi-extents kernel: x [B, T] tensor, lengths [B]."""
        return vit_kernel.viterbi_extents(x, lengths, *self.params())

    def path(self, x, lengths):
        """Decoded states (path [B, T] int64, logp [B]) through the
        full-path Viterbi kernel: x [B, T] tensor, lengths [B]."""
        return vit_kernel.viterbi(x, lengths, *self.params())

    @torch.inference_mode()
    def decode(self, x, lengths):
        """Full path and extents with the plain ops, numpy in and out:
        (path, logp, first, last, present)."""
        device = self.mus.device
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        lengths = torch.as_tensor(np.asarray(lengths, np.int64),
                                  device=device)
        path, logp = vit_ops.viterbi(x, lengths, *self.params())
        first, last, present = vit_ops.segment_extents(path, lengths,
                                                       self.nstates)
        return tuple(t.cpu().numpy()
                     for t in (path, logp, first, last, present))

    def segments_dict(self, first, last, present):
        """One read's extents as {state_name: (first, last)}
        (right-inclusive)."""
        return {name: (int(first[i]), int(last[i]))
                for i, name in enumerate(self.state_names) if present[i]}
