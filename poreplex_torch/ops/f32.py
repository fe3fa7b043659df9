"""float32 arithmetic in the association the JAX package gets on XLA:CPU.

The poly(A) decisions compare event means and t-statistics built from
cumulative sums against thresholds, so the order in which float32 values
are added decides results near those thresholds. ``torch.cumsum`` adds in
one order on the CPU and in another on CUDA; these helpers fix one order,
XLA:CPU's, and use only elementwise operations, so the plain versions give
the same bits on both devices and the same prefix sums as the JAX package:

* ``cumsum``: blocks of 16 summed left to right, the block totals scanned
  the same way recursively, each block offset by the total before it;
* ``rowsum``: blocks of 32 summed left to right, the row padded with
  zeros split evenly before and after, recursively;
* ``fma``: a multiply-add rounded once, where XLA:CPU contracts the pair.
"""

import torch
import torch.nn.functional as F

SCAN_BLOCK = 16
SUM_BLOCK = 32


def fma(a, b, c):
    """float32 ``a * b + c`` with one rounding. The float64 product of two
    float32 values is exact, so only the sum rounds twice (to float64, then
    to float32), which differs from a fused multiply-add only when the
    float64 sum lands on a float32 rounding midpoint."""
    return (a.double() * b.double() + c.double()).float()


def _running(x):
    """Inclusive left-to-right sums along the last axis, from a zero."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
        out[..., k] = acc
    return out


def cumsum(x):
    """Inclusive prefix sums of [B, n] along the last axis."""
    batch, n = x.shape
    if n <= SCAN_BLOCK:
        return _running(x)
    pad = (-n) % SCAN_BLOCK
    inner = _running(F.pad(x, (0, pad)).reshape(batch, -1, SCAN_BLOCK))
    outer = cumsum(inner[..., -1].contiguous())
    before = F.pad(outer[:, :-1], (1, 0))
    return (inner + before[..., None]).reshape(batch, -1)[:, :n]


def rowsum(x):
    """Sums of [B, n] along the last axis, [B]."""
    batch, n = x.shape
    if n > SUM_BLOCK:
        pad = (-n) % SUM_BLOCK
        x = F.pad(x, (pad // 2, pad - pad // 2)).reshape(batch, -1, SUM_BLOCK)
    acc = x.new_zeros(x.shape[:-1])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc if n <= SUM_BLOCK else rowsum(acc)
