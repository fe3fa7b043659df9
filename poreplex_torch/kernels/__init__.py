"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper checks its inputs, launches its kernel for CUDA tensors on
the card that holds them (on that card's current stream), and runs the
plain PyTorch version from ``ops/`` for CPU tensors; any other device
raises. ``launches`` counts kernel launches per wrapper, so a run can show
that it went through the kernels.
"""

launches = {
    'lstm2_stacked': 0,
    'bidirectional_lstm': 0,
    'lstm_last': 0,
    'viterbi_extents': 0,
    'viterbi': 0,
    'detect_peaks': 0,
    'polya_dp': 0,
}


def reset_launches():
    for name in launches:
        launches[name] = 0
