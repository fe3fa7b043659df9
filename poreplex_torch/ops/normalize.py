"""Masked median and med/MAD normalization of the demux windows, with
numpy's median semantics (the mean of the two middle order statistics for
even counts)."""

import math

import torch


def masked_median(x, valid, fill=math.inf):
    """Median over the valid entries of each row. x/valid: [B, T]."""
    n = valid.sum(dim=1)
    xs = torch.sort(torch.where(valid, x, fill), dim=1).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    vlo = torch.gather(xs, 1, lo[:, None])[:, 0]
    vhi = torch.gather(xs, 1, hi[:, None])[:, 0]
    return 0.5 * (vlo + vhi)


def med_mad_normalize(x, valid, mad_scale=1.4826, mad_floor=0.01):
    """(x - med) / max(mad_floor, mad * mad_scale) over the valid entries."""
    med = masked_median(x, valid)
    mad = masked_median(torch.abs(x - med[:, None]), valid)
    denom = torch.clamp(mad * mad_scale, min=mad_floor)
    return (x - med[:, None]) / denom[:, None]
