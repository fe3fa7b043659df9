"""Plain PyTorch batched HMM Viterbi and segment extents.

The reference version of the CUDA kernel in ``kernels/viterbi.py``, with
the semantics of poreplex-tpu's ``ops/viterbi.py``:

* emissions are Gaussian mixtures with K components per state (unused
  components carry a log-weight of NEG_INF), combined by a log-sum-exp
  with an explicit max shift, in the same operation order as the TPU
  kernel's ``_emission_tile``; the kernel repeats that order so its
  decisions agree exactly;
* argmax ties resolve to the first (lowest) state index;
* frames past a read's length keep the score and carry the identity
  backpointer, so padding never changes a read's decode;
* extents are those of each state's LAST contiguous run (right-inclusive).
"""

import numpy as np
import torch

LOG_2PI = float(np.log(2.0 * np.pi))
NEG_INF = -1e30


def emission_const(sigmas, logws):
    """Per-component constant of the log density, ``logw - log(sigma) -
    log(2 pi) / 2`` [S, K]; the kernel takes it precomputed so both
    versions add the same float32 values."""
    return logws - torch.log(sigmas) - 0.5 * LOG_2PI


def emission_logprob(x, mus, sigmas, const):
    """x [B, T] -> log p(x | state) [B, T, S]."""
    z = (x[..., None, None] - mus) / sigmas                  # [B, T, S, K]
    comp = const - 0.5 * z * z
    m = torch.clamp(comp.amax(dim=-1, keepdim=True), min=NEG_INF)
    acc = torch.exp(comp[..., 0:1] - m)
    for k in range(1, comp.shape[-1]):
        acc = acc + torch.exp(comp[..., k:k + 1] - m)
    return (m + torch.log(acc))[..., 0]


def viterbi(x, lengths, log_start, log_trans, mus, sigmas, logws):
    """x [B, T] padded observations, lengths [B]; log_trans[from, to].
    Returns (path [B, T] int64, logp [B]). Path entries past a read's
    length repeat its final decoded state."""
    batch, seqlen = x.shape
    nstates = log_start.shape[0]
    emis = emission_logprob(x, mus, sigmas, emission_const(sigmas, logws))
    lengths = lengths.to(torch.int64)
    iota = torch.arange(nstates, device=x.device).expand(batch, nstates)

    score = log_start[None, :] + emis[:, 0]
    bps = torch.empty((seqlen, batch, nstates), dtype=torch.int64,
                      device=x.device)
    for t in range(1, seqlen):
        terms = score[:, :, None] + log_trans[None]          # [B, from, to]
        best = terms.amax(dim=1)
        # argmax returns the first maximal index: lowest predecessor wins
        bp = torch.argmax((terms == best[:, None, :]).to(torch.int32), dim=1)
        active = (t < lengths)[:, None]
        score = torch.where(active, best + emis[:, t], score)
        bps[t] = torch.where(active, bp, iota)
    logp = score.amax(dim=-1)
    state = torch.argmax(score, dim=-1)

    path = torch.empty((batch, seqlen), dtype=torch.int64, device=x.device)
    path[:, seqlen - 1] = state
    for t in range(seqlen - 1, 0, -1):
        state = torch.gather(bps[t], 1, state[:, None])[:, 0]
        path[:, t - 1] = state
    return path, logp


def segment_extents(path, lengths, nstates):
    """Per-state (first, last) frames of the LAST contiguous run of each
    state within a read's length. Returns (first [B, S], last [B, S],
    present [B, S]); first/last are -1 where the state does not occur."""
    batch, seqlen = path.shape
    iota = torch.arange(seqlen, device=path.device)[None, :]
    valid = iota < lengths.to(torch.int64)[:, None]
    changed = torch.ones_like(path, dtype=torch.bool)
    changed[:, 1:] = path[:, 1:] != path[:, :-1]
    run_id = torch.cumsum(changed.to(torch.int64), dim=1) - 1

    firsts, lasts, presents = [], [], []
    for s in range(nstates):
        occ = (path == s) & valid
        present = occ.any(dim=1)
        last_t = torch.where(occ, iota, -1).amax(dim=1)
        rid = torch.gather(run_id, 1, last_t.clamp(min=0)[:, None])
        in_run = (run_id == rid) & occ
        first = torch.where(in_run, iota, seqlen).amin(dim=1)
        last = torch.where(in_run, iota, -1).amax(dim=1)
        firsts.append(torch.where(present, first, -1))
        lasts.append(torch.where(present, last, -1))
        presents.append(present)
    return (torch.stack(firsts, dim=1), torch.stack(lasts, dim=1),
            torch.stack(presents, dim=1))


def viterbi_extents(x, lengths, log_start, log_trans, mus, sigmas, logws):
    """viterbi() followed by segment_extents(): (first, last, present,
    logp), the stage-1 consumer's contract."""
    path, logp = viterbi(x, lengths, log_start, log_trans, mus, sigmas,
                         logws)
    first, last, present = segment_extents(path, lengths,
                                           log_start.shape[0])
    return first, last, present, logp
