"""Network and HMM parameters as the port's state dicts.

Inputs are arrays (numpy, or tensors) in the JAX package's layout: a
mapping of ``'<layer>/<key>'`` names (the layout of the preset ``.npz``
bundles and of the trainers' checkpoints, Keras gate order [i, f, c, o],
used verbatim) or the nested ``{layer: {key: array}}`` parameters of a
trainer's ``init_params``, and for the HMM the five dense arrays
poreplex-tpu's ``SegmentationHMM`` builds from the preset's state list.
The port's model loading and its trainers go through these functions, and
``checkpoint_arrays`` turns a network back into the flat layout.
"""

import numpy as np
import torch
from torch import nn

LSTM_KEYS = ('kernel', 'recurrent', 'bias')
DENSE_KEYS = ('kernel', 'bias')
SCALER_LAYERS = {'lstm1': LSTM_KEYS, 'lstm2': LSTM_KEYS, 'dense': DENSE_KEYS}
DEMUX_LAYERS = {'bilstm_fwd': LSTM_KEYS, 'bilstm_bwd': LSTM_KEYS,
                'lstm2': LSTM_KEYS, 'dense': DENSE_KEYS}
HMM_KEYS = ('log_start', 'log_trans', 'mus', 'sigmas', 'logws')
NEG_INF = -1e30


def _tensor(value, device=None, requires_grad=False):
    """A float32 copy of an array or tensor, on ``device`` (a tensor's own
    device if None)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to(device=device, dtype=torch.float32, copy=True)
    else:
        t = torch.tensor(np.asarray(value, dtype=np.float32), device=device)
    return t.requires_grad_(requires_grad)


def _array(params, layer, key):
    """params['<layer>/<key>'] of a flat mapping, else params[layer][key]."""
    name = layer + '/' + key
    return params[name] if name in params else params[layer][key]


def _state_dict(params, layers, device, requires_grad):
    return {'{}.{}'.format(layer, key):
            _tensor(_array(params, layer, key), device, requires_grad)
            for layer, keys in layers.items() for key in keys}


def scaler_state_dict(params, device=None, requires_grad=False):
    """{'lstm1.kernel': ..., 'lstm2.recurrent': ..., 'dense.bias': ...}:
    float32 tensors on ``device``, leaves that require grad if asked."""
    return _state_dict(params, SCALER_LAYERS, device, requires_grad)


def demux_state_dict(params, device=None, requires_grad=False):
    """{'bilstm_fwd.kernel': ..., 'lstm2.bias': ..., 'dense.kernel': ...}"""
    return _state_dict(params, DEMUX_LAYERS, device, requires_grad)


def parameter_dicts(module, state, layers):
    """Attach ``state`` ({'<layer>.<key>': tensor}) to ``module`` as one
    ParameterDict per layer; a parameter requires grad where its tensor
    does."""
    for layer, keys in layers.items():
        tensors = {key: state['{}.{}'.format(layer, key)] for key in keys}
        setattr(module, layer, nn.ParameterDict({
            key: nn.Parameter(t, requires_grad=t.requires_grad)
            for key, t in tensors.items()}))


def checkpoint_arrays(module, layers):
    """The module's parameters as the flat ``'<layer>/<key>'`` float32
    numpy arrays a checkpoint holds, in the order of ``layers``."""
    return {'{}/{}'.format(layer, key):
            getattr(module, layer)[key].detach().cpu().numpy().astype(
                np.float32)
            for layer, keys in layers.items() for key in keys}


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
