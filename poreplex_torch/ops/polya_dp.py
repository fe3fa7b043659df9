"""Best poly(A) interval by dynamic programming: the plain PyTorch version
of the CUDA kernel in ``kernels/polya_dp.py``, with the semantics of
poreplex-tpu's ``ops/polya_dp.py`` and ``ops/pallas_polya_dp.py``.

Every live start lane shares one spike budget, so the reference's O(K^2)
matrix DP runs as an O(K) sequential recurrence over the event columns,
vectorized over rows. Per column j: the running score prefix (column
scores truncated toward zero, as the reference's float products assigned
into int64 cells), the spike budget S (reset at a poly(A) event, death of
every lane at S > tolerance), the running minimum of the packed
(exclusive prefix + VOFF) * K + start over poly(A) start lanes since the
last death, and the row-major-first argmax of (prefix - that minimum):
higher score, then smaller start, then earlier end. All arithmetic is
int32, so every version agrees exactly.
"""

import torch

INT_MIN = -2 ** 31 + 1
# prefix scores are bounded by spike_weight * window length (the pipeline
# caps windows so that (value + VOFF) * K + index fits int32)
VOFF = 1 << 20
PACK_INF = 2 ** 31 - 1


def column_scores(is_polya, length, spike_weight):
    """(col_match, spike_len) int32 [B, K]: the event length for a poly(A)
    event and -spike_weight times it otherwise, truncated toward zero; the
    truncated length of spike events and 0 for poly(A) ones."""
    col = torch.where(is_polya, length, -float(spike_weight) * length)
    col_match = torch.trunc(col).to(torch.int32)
    spike_len = torch.where(is_polya, 0, torch.trunc(length).to(torch.int32))
    return col_match, spike_len


def dp_core(is_polya, length, n_events, spike_weight, spike_tolerance):
    """is_polya [B, K] bool, length [B, K] float32, n_events [B]. Returns
    (start, end, score) int32 [B], inclusive event indices of the best
    interval; all three are 0 where no interval scores above 0."""
    batch, kmax = is_polya.shape
    col_match, spike_len = column_scores(is_polya, length, spike_weight)
    n_events = n_events.to(torch.int32)
    tol = int(spike_tolerance)

    def full(value):
        return torch.full((batch,), value, dtype=torch.int32,
                          device=is_polya.device)

    prefix, budget = full(0), full(0)
    runmin, best_val, best_i, best_j = (full(PACK_INF), full(INT_MIN),
                                        full(kmax), full(0))
    for j in range(kmax):
        isp = is_polya[:, j]
        prefix_ex = prefix
        prefix = prefix + col_match[:, j]
        budget = torch.where(isp, 0, budget + spike_len[:, j])
        died = ~isp & (budget > tol)
        cand = torch.where(isp, (prefix_ex + VOFF) * kmax + j, PACK_INF)
        runmin = torch.minimum(torch.where(died, PACK_INF, runmin), cand)
        run_val = runmin // kmax - VOFF
        run_i = runmin % kmax
        valid = ((j < n_events) & (isp | (budget < tol)) &
                 (runmin < PACK_INF))
        val = torch.where(valid, prefix - run_val, INT_MIN)
        take = (val > best_val) | ((val == best_val) & (run_i < best_i))
        best_val = torch.where(take, val, best_val)
        best_i = torch.where(take, run_i, best_i)
        best_j = torch.where(take, j, best_j)
    found = best_val > 0
    return (torch.where(found, best_i, 0), torch.where(found, best_j, 0),
            torch.where(found, best_val, 0))
