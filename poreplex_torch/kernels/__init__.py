"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper checks its inputs, launches its kernel for CUDA tensors on
the card that holds them (on that card's current stream), and runs the
plain PyTorch version from ``ops/`` for CPU tensors; any other device
raises. ``launches`` counts kernel launches per wrapper, so a run can show
that it went through the kernels; ``instantiations`` counts them by the
kernel function and the shape it was instantiated for (the wrappers pick
one from their inputs' shapes), e.g. ``'lstm_general_kernel'`` or
``'viterbi_path_kernel<8,0>'``. A CUDA graph's capture launches nothing:
its counts are taken off at capture (``take_counts``) and added again at
each replay (``add_counts``).
"""

import collections

launches = {
    'lstm2_stacked': 0,
    'bidirectional_lstm': 0,
    'lstm_last': 0,
    'viterbi_extents': 0,
    'viterbi': 0,
    'detect_peaks': 0,
    'polya_dp': 0,
}
instantiations = collections.Counter()


def count(wrapper, function):
    """One launch of kernel ``function`` by ``wrapper``."""
    launches[wrapper] += 1
    instantiations[function] += 1


def reset_launches():
    for name in launches:
        launches[name] = 0
    instantiations.clear()


def counts():
    """The counts as they stand: (launches, instantiations), copied."""
    return dict(launches), collections.Counter(instantiations)


def take_counts(before):
    """The launches counted since ``before`` (a ``counts()``), taken off
    the totals."""
    launched, instantiated = before
    taken = ({name: n - launched[name] for name, n in launches.items()},
             instantiations - instantiated)
    launches.update(launched)
    instantiations.clear()
    instantiations.update(instantiated)
    return taken


def add_counts(taken):
    """Counts taken by ``take_counts``, added once more."""
    launched, instantiated = taken
    for name, n in launched.items():
        launches[name] += n
    instantiations.update(instantiated)
