"""Plain float32 PyTorch versions of the networks and the HMM Viterbi:
frozen copies of ``poreplex_torch``'s ``ops/rnn.py``, ``ops/viterbi.py``,
``ops/normalize.py`` and ``weights.hmm_arrays``. Weights are Keras-ordered
``kernel`` [I, 4H], ``recurrent`` [H, 4H], ``bias`` [4H]."""

import math

import numpy as np
import torch

LOG_2PI = float(np.log(2.0 * np.pi))
NEG_INF = -1e30


def full_fp32():
    """No TF32 in matrix products: the networks run in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def accurate_tanh(x):
    x = torch.clamp(x, -20.0, 20.0)
    t = torch.expm1(2.0 * x)
    return t / (t + 2.0)


def lstm_gates(z, c_prev):
    h4 = z.shape[-1] // 4
    i = torch.sigmoid(z[..., 0 * h4:1 * h4])
    f = torch.sigmoid(z[..., 1 * h4:2 * h4])
    g = accurate_tanh(z[..., 2 * h4:3 * h4])
    o = torch.sigmoid(z[..., 3 * h4:4 * h4])
    c = f * c_prev + i * g
    return o * accurate_tanh(c), c


def project(params, xs):
    batch, seqlen, _ = xs.shape
    zx = torch.matmul(xs.reshape(batch * seqlen, -1), params['kernel']) + \
        params['bias']
    return zx.reshape(batch, seqlen, -1)


def lstm(params, xs, reverse=False, return_sequences=True):
    """One LSTM layer over xs [B, T, I]: [B, T, H] or the last h [B, H]."""
    if reverse:
        xs = torch.flip(xs, (1,))
    zx = project(params, xs)
    batch, seqlen, _ = zx.shape
    rec = params['recurrent']
    h = zx.new_zeros((batch, rec.shape[0]))
    c = torch.zeros_like(h)
    hs = zx.new_empty((batch, seqlen, rec.shape[0]))
    for t in range(seqlen):
        h, c = lstm_gates(zx[:, t] + torch.matmul(h, rec), c)
        hs[:, t] = h
    if not return_sequences:
        return h
    return torch.flip(hs, (1,)) if reverse else hs


def lstm2_stacked(params1, params2, xs):
    """Two stacked LSTM layers; layer 2's last h [B, H2]."""
    zx = project(params1, xs)
    r1, r2 = params1['recurrent'], params2['recurrent']
    k2, b2 = params2['kernel'], params2['bias']
    batch, seqlen, _ = zx.shape
    h1 = zx.new_zeros((batch, r1.shape[0]))
    c1 = torch.zeros_like(h1)
    h2 = zx.new_zeros((batch, r2.shape[0]))
    c2 = torch.zeros_like(h2)
    for t in range(seqlen):
        h1, c1 = lstm_gates(zx[:, t] + torch.matmul(h1, r1), c1)
        h2, c2 = lstm_gates(torch.matmul(h1, k2) + b2 +
                            torch.matmul(h2, r2), c2)
    return h2


def dense(params, xs):
    return torch.matmul(xs, params['kernel']) + params['bias']


def masked_median(x, valid, fill=math.inf):
    n = valid.sum(dim=1)
    xs = torch.sort(torch.where(valid, x, fill), dim=1).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    return 0.5 * (torch.gather(xs, 1, lo[:, None])[:, 0] +
                  torch.gather(xs, 1, hi[:, None])[:, 0])


def med_mad_normalize(x, valid, mad_scale=1.4826, mad_floor=0.01):
    med = masked_median(x, valid)
    mad = masked_median(torch.abs(x - med[:, None]), valid)
    denom = torch.clamp(mad * mad_scale, min=mad_floor)
    return (x - med[:, None]) / denom[:, None]


# ---------------------------------------------------------------- HMM

def hmm_arrays(spec, device):
    """(state names, log_start, log_trans, mus, sigmas, logws) as float32
    tensors, with pomegranate's normalisation of mixture weights and of
    each state's outgoing transitions."""
    index = {s['name']: i for i, s in enumerate(spec)}
    nstates = len(spec)
    maxk = max(len(s['emission']) for s in spec)
    mus = np.zeros((nstates, maxk))
    sigmas = np.ones((nstates, maxk))
    logws = np.full((nstates, maxk), NEG_INF)
    for i, s in enumerate(spec):
        comps = s['emission']
        if len(comps) == 1:
            mus[i, 0], sigmas[i, 0] = comps[0][:2]
            logws[i, 0] = 0.0
        else:
            w = np.array([c[2] for c in comps], np.float64)
            w = w / w.sum()
            for k, c in enumerate(comps):
                mus[i, k], sigmas[i, k] = c[:2]
                logws[i, k] = np.log(w[k])
    log_start = np.full(nstates, NEG_INF)
    log_trans = np.full((nstates, nstates), NEG_INF)
    for i, s in enumerate(spec):
        if 'start_prob' in s:
            log_start[i] = np.log(s['start_prob'])
        probs = np.array([p for _, p in s['transition']], np.float64)
        probs = probs / probs.sum()
        for (nxt, _), p in zip(s['transition'], probs):
            log_trans[i, index[nxt]] = np.log(p)
    tensors = [torch.tensor(a.astype(np.float32), device=device)
               for a in (log_start, log_trans, mus, sigmas, logws)]
    return [s['name'] for s in spec], tensors


def emission_logprob(x, mus, sigmas, logws):
    """x [B, T] -> log p(x | state) [B, T, S]: a log-sum-exp over each
    state's components with an explicit max shift."""
    const = logws - torch.log(sigmas) - 0.5 * LOG_2PI
    z = (x[..., None, None] - mus) / sigmas
    comp = const - 0.5 * z * z
    m = torch.clamp(comp.amax(dim=-1, keepdim=True), min=NEG_INF)
    acc = torch.exp(comp[..., 0:1] - m)
    for k in range(1, comp.shape[-1]):
        acc = acc + torch.exp(comp[..., k:k + 1] - m)
    return (m + torch.log(acc))[..., 0]


def viterbi(x, lengths, log_start, log_trans, mus, sigmas, logws):
    """Decoded states [B, T] of padded observations x [B, T] with lengths
    [B]: ties go to the lowest predecessor, frames past a read's length
    repeat its last state."""
    batch, seqlen = x.shape
    nstates = log_start.shape[0]
    emis = emission_logprob(x, mus, sigmas, logws)
    lengths = lengths.to(torch.int64)
    iota = torch.arange(nstates, device=x.device).expand(batch, nstates)
    score = log_start[None, :] + emis[:, 0]
    bps = torch.empty((seqlen, batch, nstates), dtype=torch.int64,
                      device=x.device)
    for t in range(1, seqlen):
        terms = score[:, :, None] + log_trans[None]
        best = terms.amax(dim=1)
        bp = torch.argmax((terms == best[:, None, :]).to(torch.int32), dim=1)
        active = (t < lengths)[:, None]
        score = torch.where(active, best + emis[:, t], score)
        bps[t] = torch.where(active, bp, iota)
    state = torch.argmax(score, dim=-1)
    path = torch.empty((batch, seqlen), dtype=torch.int64, device=x.device)
    path[:, seqlen - 1] = state
    for t in range(seqlen - 1, 0, -1):
        state = torch.gather(bps[t], 1, state[:, None])[:, 0]
        path[:, t - 1] = state
    return path


def last_run_extents(path, length, nstates):
    """{state: (first, last)} of each state's last contiguous run within
    the first ``length`` frames of one decoded path (numpy)."""
    path = path[:length]
    out = {}
    if length == 0:
        return out
    change = np.flatnonzero(np.diff(path)) + 1
    firsts = np.concatenate([[0], change])
    lasts = np.concatenate([change - 1, [length - 1]])
    for first, last in zip(firsts, lasts):
        out[int(path[first])] = (int(first), int(last))
    return out
