"""Network and HMM parameters as the port's state dicts.

Inputs are numpy arrays in the JAX package's layout: a mapping of
``'<layer>/<key>'`` names (the layout of the preset ``.npz`` bundles,
Keras gate order [i, f, c, o], used verbatim), and for the HMM the five
dense arrays poreplex-tpu's ``SegmentationHMM`` builds from the preset's
state list. The port's own model loading goes through these functions.
"""

import numpy as np
import torch

LSTM_KEYS = ('kernel', 'recurrent', 'bias')
DENSE_KEYS = ('kernel', 'bias')
SCALER_LAYERS = {'lstm1': LSTM_KEYS, 'lstm2': LSTM_KEYS, 'dense': DENSE_KEYS}
DEMUX_LAYERS = {'bilstm_fwd': LSTM_KEYS, 'bilstm_bwd': LSTM_KEYS,
                'lstm2': LSTM_KEYS, 'dense': DENSE_KEYS}
HMM_KEYS = ('log_start', 'log_trans', 'mus', 'sigmas', 'logws')
NEG_INF = -1e30


def _tensor(array):
    return torch.tensor(np.asarray(array, dtype=np.float32))


def _state_dict(arrays, layers):
    return {'{}.{}'.format(layer, key): _tensor(arrays[layer + '/' + key])
            for layer, keys in layers.items() for key in keys}


def scaler_state_dict(arrays):
    """{'lstm1.kernel': ..., 'lstm2.recurrent': ..., 'dense.bias': ...}"""
    return _state_dict(arrays, SCALER_LAYERS)


def demux_state_dict(arrays):
    """{'bilstm_fwd.kernel': ..., 'lstm2.bias': ..., 'dense.kernel': ...}"""
    return _state_dict(arrays, DEMUX_LAYERS)


def hmm_arrays(spec):
    """Dense HMM arrays from a preset state list (name, emission as
    [mu, sigma] or [mu, sigma, weight] components, transition as
    [next_state, prob], optional start_prob), with pomegranate's
    normalisation of mixture weights and outgoing transitions."""
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
            weights = np.array([c[2] for c in comps], dtype=np.float64)
            weights = weights / weights.sum()
            for k, c in enumerate(comps):
                mus[i, k], sigmas[i, k] = c[:2]
                logws[i, k] = np.log(weights[k])

    log_start = np.full(nstates, NEG_INF)
    log_trans = np.full((nstates, nstates), NEG_INF)
    for i, s in enumerate(spec):
        if 'start_prob' in s:
            log_start[i] = np.log(s['start_prob'])
        probs = np.array([p for _, p in s['transition']], dtype=np.float64)
        probs = probs / probs.sum()
        for (nxt, _), p in zip(s['transition'], probs):
            log_trans[i, index[nxt]] = np.log(p)
    return {'log_start': log_start, 'log_trans': log_trans, 'mus': mus,
            'sigmas': sigmas, 'logws': logws}


def hmm_state_dict(arrays):
    """float32 tensors of the five HMM arrays."""
    return {key: _tensor(arrays[key]) for key in HMM_KEYS}
