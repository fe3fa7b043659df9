"""Wrappers of the LSTM recurrence kernels (``csrc/lstm.cu``).

Same signatures and results as the plain versions in ``ops/rnn.py``, which
run for CPU tensors. For CUDA tensors each launches a kernel of one of two
designs, which ``plan`` picks from the shapes:

  lstm2_stacked       two stacked LSTM layers, layer 2's last h   [B, H2]
  bidirectional_lstm  Keras Bidirectional(concat), every step     [B, T, 2H]
  lstm_last           one LSTM layer, the last h                  [B, H]

* The register design (one launch): the scaler's and the demultiplexer's
  shipped shapes and every narrower one, and a BiLSTM of up to 64 units.
  The kernels are instantiated at the widths of ``STACKED_HIDDEN``,
  ``SEQ_HIDDEN`` and ``LAST_HIDDEN``, the first two for a width-1 input,
  whose projection they fold in whole; a narrower layer runs at the next
  such width with inert units (zero kernel, recurrent and bias entries, so
  its h stays 0 and adds exact zeros), and stacked layers at the wider
  one's. The BiLSTM's kernel makes its inert units itself: it takes the
  weights unpadded and writes [B, T, 2H] whole. The LSTM's input product
  is one ``torch.matmul`` (hoisted out of the recurrence, as in the JAX
  package), and its kernel adds the bias itself.
* The general design, any other shape (wider layers, a wider input): one
  launch of ``lstm_general_kernel`` for a layer or both directions of one,
  of ``lstm2_stacked_general_kernel`` for the two stacked layers (layer
  2's input product computed in its steps). A first layer's input product
  is one ``torch.matmul`` beside the kernel unless the input has width 1.
  A thread-block cluster of ``cluster`` blocks (1, 2, 4 or 8, the smallest
  whose blocks hold every weight row) serves 4 reads: each block owns a
  contiguous range of each layer's units (``unit_range``), keeps those
  units' columns of every weight matrix in its shared memory and computes
  their whole dot products, in the same order at any cluster size, and
  writes their new h into every block of the cluster over distributed
  shared memory (``st.async`` onto the receiving block's mbarrier, which
  the next step waits on). So no weight is read from device memory in a
  step, and no sum crosses blocks: what bounds a step is a block's share
  of the weights and of h read from shared memory, then the gates and
  the h's way to the partners. Only where even 8 blocks cannot hold every
  row (LSTM(256) x 2) do a block's first ``smem_rows`` rows sit in shared
  memory and the rest of its columns come from device memory every step.
  A cluster that the card cannot schedule (``cudaOccupancyMaxActiveClusters``
  0, read at the first launch of a shape) raises; no launch falls back to
  a smaller cluster.
"""

import collections
import ctypes

import torch

from . import count, _build
from ..ops import rnn

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'pp_lstm2_stacked': [_P] * 8 + [_I, _I, _I, _P],
    'pp_lstm_seq': [_P] * 8 + [_I, _I, _I, _P],
    'pp_lstm_last': [_P] * 4 + [_I, _I, _I, _P],
    'pp_lstm_general': [_P] * 8 + [_I] * 9 + [_P],
    'pp_lstm2_stacked_general': [_P] * 8 + [_I] * 7 + [_P],
    'pp_lstm_max_clusters': [_I] * 8 + [_P],
    'pp_lstm_launch_shape': [_I, _I, _I, _I, _P],
}
# the register design's widths (csrc/lstm.cu STACKED_WIDTHS, SEQ_WIDTHS,
# LAST_WIDTHS): the shipped networks' and, for the BiLSTM, every multiple of
# 8 from 48 to its widest without a register spill. A narrower stacked or
# last layer is padded to the next such width with inert units;
# bilstm_kernel takes a layer of its own width unpadded at the next one
STACKED_HIDDEN = (48,)
SEQ_HIDDEN = (48, 56, 64)
LAST_HIDDEN = (48, 64)
# a block of the register design holds 2 reads; a cluster of the general
# design G_ROWS reads, and each of its blocks G_SPLIT lanes a unit it owns
# (whole warps), up to G_MAX_THREADS threads
# (G_LAYER_THREADS a layer of the stacked kernel), and at most SMEM_BYTES
# of shared memory (the H100's opt-in limit): its two step barriers
# (BARRIER_BYTES), weight rows of 16 bytes a unit it owns, and a layer's
# state of 4 G_ROWS bytes a unit it owns (c) and 8 G_ROWS bytes a unit of
# the layer (h twice)
ROWS = 2
G_ROWS = 4
G_SPLIT = 4
BARRIER_BYTES = 16
G_MAX_THREADS = 512
G_LAYER_THREADS = 256
SMEM_BYTES = 232448
# the portable cluster sizes, smallest first
CLUSTER_SIZES = (1, 2, 4, 8)
# kernel numbers of pp_lstm_launch_shape
_SHAPE_KERNELS = {'lstm2_stacked_kernel': 0, 'bilstm_kernel': 1,
                  'lstm_last_kernel': 2, 'lstm_general_kernel': 3,
                  'lstm2_stacked_general_kernel': 4}

# one launch: the kernel function, the width it runs at ((H1, H2) for
# lstm2_stacked_general_kernel), (reads per block (per cluster in the
# general design), threads per block, blocks), the rows of each weight
# matrix's columns a block keeps in shared memory and the blocks of a
# cluster (general design; None for the register one)
Launch = collections.namedtuple('Launch',
                                'kernel hidden shape smem_rows cluster')
Plan = collections.namedtuple('Plan', 'route launches')
# cudaOccupancyMaxActiveClusters by (card, kernel, hidden, shape,
# smem_rows, cluster, fold), read at the first launch of each
_max_clusters = {}


def _register_width(widths, hidden):
    """The narrowest instantiated width that holds ``hidden`` units, or
    None."""
    return next((w for w in widths if w >= hidden), None)


def _layer_threads(hidden, most):
    return min(most, -(-hidden * G_SPLIT // 32) * 32)


def unit_range(hidden, cluster, rank):
    """The units [first, end) of a layer of ``hidden`` units that block
    ``rank`` of a cluster of ``cluster`` blocks owns (csrc/lstm.cu's
    unit_begin): contiguous ranges that differ by at most one unit."""
    return rank * hidden // cluster, (rank + 1) * hidden // cluster


def _most_units(hidden, cluster):
    return -(-hidden // cluster)


def _general_smem(hidden, cluster, rows):
    """Shared memory bytes of a block of lstm_general_kernel in a cluster
    of ``cluster`` keeping ``rows`` rows of its units' columns."""
    units = _most_units(hidden, cluster)
    return (BARRIER_BYTES + 16 * rows * units +
            4 * G_ROWS * (2 * hidden + units))


def _stacked_smem(hidden1, hidden2, cluster, rows):
    """Shared memory bytes of a block of lstm2_stacked_general_kernel in
    a cluster of ``cluster`` keeping the first ``rows`` rows of its units'
    columns of r1, k2 and r2 (as far as each has them)."""
    n1, n2 = min(rows, hidden1), min(rows, hidden2)
    m1, m2 = _most_units(hidden1, cluster), _most_units(hidden2, cluster)
    return (BARRIER_BYTES + 16 * (n1 * (m1 + m2) + n2 * m2) +
            4 * G_ROWS * (2 * hidden1 + 2 * hidden2 + m1 + m2))


def _cluster_and_rows(hidden, smem, rows):
    """(cluster, rows in shared memory): the smallest portable cluster
    whose blocks hold all ``rows``; else the largest, with as many rows as
    fit. ``smem(cluster, rows)`` gives a block's bytes."""
    for cluster in CLUSTER_SIZES:
        if smem(cluster, rows) <= SMEM_BYTES:
            return cluster, rows
    cluster = CLUSTER_SIZES[-1]
    if smem(cluster, 0) > SMEM_BYTES:
        raise ValueError('no LSTM kernel for width {}: its state needs {} '
                         'bytes of shared memory'.format(
                             hidden, smem(cluster, 0)))
    lo, hi = 0, rows   # the most rows that fit
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem(cluster, mid) <= SMEM_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return cluster, lo


def _general_launch(batch, hidden, directions=1):
    cluster, rows = _cluster_and_rows(
        hidden, lambda c, r: _general_smem(hidden, c, r), hidden)
    blocks = -(-batch // G_ROWS) * cluster * directions
    threads = _layer_threads(_most_units(hidden, cluster), G_MAX_THREADS)
    return Launch('lstm_general_kernel', hidden, (G_ROWS, threads, blocks),
                  rows, cluster)


def _stacked_threads(hidden1, hidden2, cluster):
    """(layer 1's, layer 2's) threads of a block of
    lstm2_stacked_general_kernel (csrc/lstm.cu's stacked_threads): each
    layer G_SPLIT lanes a unit it owns."""
    return tuple(_layer_threads(_most_units(h, cluster), G_LAYER_THREADS)
                 for h in (hidden1, hidden2))


def _stacked_general_launch(batch, hidden1, hidden2):
    cluster, rows = _cluster_and_rows(
        (hidden1, hidden2),
        lambda c, r: _stacked_smem(hidden1, hidden2, c, r),
        max(hidden1, hidden2))
    threads = sum(_stacked_threads(hidden1, hidden2, cluster))
    return Launch('lstm2_stacked_general_kernel', (hidden1, hidden2),
                  (G_ROWS, threads, -(-batch // G_ROWS) * cluster), rows,
                  cluster)


def plan(name, batch, inputs, hidden1, hidden2=None):
    """The design and launches of wrapper ``name`` for ``batch`` reads of
    input width ``inputs`` and layer widths ``hidden1`` (and ``hidden2``,
    layer 2 of lstm2_stacked): Plan(route 'register' or 'general', a
    Launch for each launch). Pure: no card needed."""
    if min(batch, inputs, hidden1, hidden2 or 1) < 1:
        raise ValueError('{}: empty shape'.format(name))
    blocks = -(-batch // ROWS)
    if name == 'lstm2_stacked':
        width = _register_width(STACKED_HIDDEN, max(hidden1, hidden2))
        if inputs == 1 and width:
            return Plan('register', (Launch(
                'lstm2_stacked_kernel', width, (ROWS, 8 * width, blocks),
                None, None),))
        return Plan('general', (_stacked_general_launch(batch, hidden1,
                                                        hidden2),))
    if name == 'bidirectional_lstm':
        width = _register_width(SEQ_HIDDEN, hidden1)
        if inputs == 1 and width:
            return Plan('register', (Launch(
                'bilstm_kernel', width, (ROWS, 4 * width, blocks), None,
                None),))
        return Plan('general', (_general_launch(batch, hidden1, 2),))
    if name == 'lstm_last':
        width = _register_width(LAST_HIDDEN, hidden1)
        if width:
            return Plan('register', (Launch(
                'lstm_last_kernel', width, (ROWS, 2 * width, blocks), None,
                None),))
        return Plan('general', (_general_launch(batch, hidden1),))
    raise ValueError('no LSTM wrapper {}'.format(name))


def _lib():
    return _build.library('lstm.cu', _SIGNATURES)


def launch_shape(kernel, batch, hidden):
    """(reads per block (per cluster), threads per block, blocks, blocks
    a cluster (0: no cluster)) of one direction of ``kernel`` (a Launch's
    kernel) for ``batch`` reads of width ``hidden`` (a Launch's hidden),
    as the C side launches it."""
    h1, h2 = hidden if isinstance(hidden, tuple) else (hidden, 0)
    shape = (ctypes.c_int * 4)()
    _build.check(_lib().pp_lstm_launch_shape(_SHAPE_KERNELS[kernel], h1, h2,
                                             batch, ctypes.addressof(shape)),
                 kernel)
    return tuple(shape)


def max_active_clusters(launch, batch, fold, directions=1):
    """cudaOccupancyMaxActiveClusters of a general ``launch`` for
    ``batch`` reads on the current card: how many of its clusters the card
    holds at once (0: none can be scheduled)."""
    h1, h2 = launch.hidden if isinstance(launch.hidden, tuple) else \
        (launch.hidden, 0)
    count = ctypes.c_int()
    _build.check(_lib().pp_lstm_max_clusters(
        _SHAPE_KERNELS[launch.kernel], h1, h2, batch, directions, int(fold),
        launch.cluster, launch.smem_rows, ctypes.byref(count)), launch.kernel)
    return count.value


def _check_schedulable(name, launch, batch, fold, directions, device):
    """At the first launch of a shape on a card: raises unless the card
    can hold at least one of its clusters."""
    key = (device.index, launch.kernel, launch.hidden, launch.shape,
           launch.smem_rows, launch.cluster, bool(fold))
    count = _max_clusters.get(key)
    if count is None:
        count = _max_clusters[key] = max_active_clusters(launch, batch, fold,
                                                         directions)
    if count < 1:
        raise RuntimeError(
            '{}: the card cannot schedule a cluster of {} blocks of {} '
            'threads for {} (cudaOccupancyMaxActiveClusters 0)'.format(
                name, launch.cluster, launch.shape[1], launch.kernel))


def _check_layer(name, params, inputs):
    rec = params['recurrent']
    hidden = rec.shape[0]
    if (rec.dim() != 2 or tuple(rec.shape) != (hidden, 4 * hidden) or
            tuple(params['kernel'].shape) != (inputs, 4 * hidden) or
            tuple(params['bias'].shape) != (4 * hidden,)):
        raise ValueError('{}: weight shapes do not match'.format(name))
    for t in params.values():
        if t.dtype != torch.float32:
            raise ValueError('{}: weights must be float32'.format(name))
    return hidden


def _check_input(name, xs):
    if xs.dim() != 3 or xs.dtype != torch.float32:
        raise ValueError('{}: xs must be float32 [B, T, I]'.format(name))
    if xs.shape[0] == 0 or xs.shape[1] == 0:
        raise ValueError('{}: empty batch or sequence'.format(name))


def _pad(mat, rows, hidden):
    """mat [R, 4H] as [rows, 4 * hidden]: gate q's H columns from
    q * hidden, zeros elsewhere (the inert units and input rows)."""
    r, h = mat.shape[0], mat.shape[1] // 4
    if (r, h) == (rows, hidden):
        return mat
    out = mat.new_zeros((rows, 4, hidden))
    out[:r, :, :h] = mat.reshape(r, 4, h)
    return out.reshape(rows, 4 * hidden)


def _pad_layer(params, inputs, hidden):
    return (_pad(params['kernel'], inputs, hidden),
            _pad(params['bias'][None], 1, hidden)[0],
            _pad(params['recurrent'], hidden, hidden))


def _general(name, xs, dirs, out, fold, seq, launch):
    """One launch of the general design over xs [B, T, I]: dirs, one or
    two (kernel, bias, recurrent) of one layer, the second reversed; fold:
    xs is the width-1 input, else its product with the kernels is taken
    here. Returns the C entry's code."""
    batch, seqlen, inputs = xs.shape
    hidden = launch.hidden
    if fold:
        x, xk_stride = xs.reshape(batch, seqlen), 0
        ks = [k.reshape(4 * hidden) for k, _, _ in dirs]
    else:
        kernel = dirs[0][0] if len(dirs) == 1 else \
            torch.cat([k for k, _, _ in dirs], dim=1)
        x = torch.matmul(xs.reshape(batch * seqlen, inputs), kernel)
        xk_stride, ks = x.shape[1], [x] * len(dirs)    # ks: not read
    sides = [(k, b, r) for k, (_, b, r) in zip(ks, dirs)]
    (k0, b0, r0), (k1, b1, r1) = (sides + sides)[:2]
    _build.require_cuda(name, x, k0, b0, r0, k1, b1, r1, out)
    p = _build.ptr
    with _build.device_guard(x):
        _check_schedulable(name, launch, batch, fold, len(dirs), x.device)
        return _lib().pp_lstm_general(
            p(x), p(k0), p(b0), p(r0), p(k1), p(b1), p(r1), p(out), batch,
            seqlen, hidden, xk_stride, len(dirs), int(fold), int(seq),
            launch.cluster, launch.smem_rows, _build.stream(xs.device))


def _launched(name, code, launch, fold=None):
    _build.check(code, name)
    if launch.smem_rows is not None:
        count(name, '{}<{}>'.format(launch.kernel,
                                    'true' if fold else 'false'))
    else:
        count(name, '{}<{}>'.format(launch.kernel, launch.hidden))


def lstm2_stacked(params1, params2, xs):
    """Two stacked LSTM layers; layer 2's last h [B, H2]."""
    if xs.device.type == 'cpu':
        return rnn.lstm2_stacked(params1, params2, xs)
    _check_input('lstm2_stacked', xs)
    batch, seqlen, inputs = xs.shape
    h1 = _check_layer('lstm2_stacked', params1, inputs)
    h2 = _check_layer('lstm2_stacked', params2, h1)
    pl = plan('lstm2_stacked', batch, inputs, h1, h2)
    launch, = pl.launches
    if pl.route == 'general':
        fold = inputs == 1
        k1 = params1['kernel']
        x = xs.reshape(batch, seqlen) if fold else \
            torch.matmul(xs.reshape(batch * seqlen, inputs), k1)
        out = torch.empty((batch, h2), dtype=torch.float32, device=xs.device)
        tensors = (x, k1, params1['bias'], params1['recurrent'],
                   params2['kernel'], params2['bias'], params2['recurrent'],
                   out)
        _build.require_cuda('lstm2_stacked', *tensors)
        with _build.device_guard(xs):
            _check_schedulable('lstm2_stacked', launch, batch, fold, 1,
                               xs.device)
            code = _lib().pp_lstm2_stacked_general(
                *[_build.ptr(t) for t in tensors], batch, seqlen, h1, h2,
                int(fold), launch.cluster, launch.smem_rows,
                _build.stream(xs.device))
        _launched('lstm2_stacked', code, launch, fold)
        return out
    width = launch.hidden
    k1, b1, r1 = _pad_layer(params1, 1, width)
    k2, b2, r2 = _pad_layer(params2, width, width)
    out = torch.empty((batch, width), dtype=torch.float32, device=xs.device)
    _build.require_cuda('lstm2_stacked', xs, k1, b1, r1, k2, b2, r2, out)
    with _build.device_guard(xs):
        code = _lib().pp_lstm2_stacked(
            _build.ptr(xs), _build.ptr(k1), _build.ptr(b1), _build.ptr(r1),
            _build.ptr(k2), _build.ptr(b2), _build.ptr(r2), _build.ptr(out),
            batch, seqlen, width, _build.stream(xs.device))
    _launched('lstm2_stacked', code, launch)
    return out if width == h2 else out[:, :h2].contiguous()


def bidirectional_lstm(fwd_params, bwd_params, xs):
    """Keras Bidirectional(concat) LSTM: [B, T, 2H]."""
    if xs.device.type == 'cpu':
        return rnn.bidirectional_lstm(fwd_params, bwd_params, xs)
    _check_input('bidirectional_lstm', xs)
    batch, seqlen, inputs = xs.shape
    hidden = _check_layer('bidirectional_lstm', fwd_params, inputs)
    if _check_layer('bidirectional_lstm', bwd_params, inputs) != hidden:
        raise ValueError('bidirectional_lstm: directions of unequal width')
    pl = plan('bidirectional_lstm', batch, inputs, hidden)
    launch, = pl.launches
    if pl.route == 'general':
        out = torch.empty((batch, seqlen, 2 * hidden), dtype=torch.float32,
                          device=xs.device)
        dirs = [(p['kernel'], p['bias'], p['recurrent'])
                for p in (fwd_params, bwd_params)]
        code = _general('bidirectional_lstm', xs, dirs, out, inputs == 1,
                        True, launch)
        _launched('bidirectional_lstm', code, launch, inputs == 1)
        return out
    # bilstm_kernel takes the weights as they are, at the layer's width,
    # and writes seq [B, T, 2H] whole
    out = torch.empty((batch, seqlen, 2 * hidden), dtype=torch.float32,
                      device=xs.device)
    tensors = [p[key] for p in (fwd_params, bwd_params)
               for key in ('kernel', 'bias', 'recurrent')]
    _build.require_cuda('bidirectional_lstm', xs, *tensors, out)
    p = _build.ptr
    with _build.device_guard(xs):
        code = _lib().pp_lstm_seq(p(xs), *[p(t) for t in tensors], p(out),
                                  batch, seqlen, hidden,
                                  _build.stream(xs.device))
    _launched('bidirectional_lstm', code, launch)
    return out


def lstm_last(params, xs):
    """One LSTM layer's last h [B, H] (return_sequences=False)."""
    if xs.device.type == 'cpu':
        return rnn.lstm(params, xs, return_sequences=False)
    _check_input('lstm_last', xs)
    batch, seqlen, inputs = xs.shape
    hidden = _check_layer('lstm_last', params, inputs)
    pl = plan('lstm_last', batch, inputs, hidden)
    launch, = pl.launches
    if pl.route == 'general':
        out = torch.empty((batch, hidden), dtype=torch.float32,
                          device=xs.device)
        layer = (params['kernel'], params['bias'], params['recurrent'])
        code = _general('lstm_last', xs, [layer], out, False, False,
                        launch)
        _launched('lstm_last', code, launch, False)
        return out
    width = launch.hidden
    kernel, bias, rec = _pad_layer(params, inputs, width)
    # rnn.project's product; the kernel adds the bias with the same rounding
    xk = torch.matmul(xs.reshape(batch * seqlen, inputs), kernel)
    out = torch.empty((batch, width), dtype=torch.float32, device=xs.device)
    _build.require_cuda('lstm_last', xk, bias, rec, out)
    with _build.device_guard(xk):
        code = _lib().pp_lstm_last(_build.ptr(xk), _build.ptr(bias),
                                   _build.ptr(rec), _build.ptr(out), batch,
                                   seqlen, width, _build.stream(xs.device))
    _launched('lstm_last', code, launch)
    return out if width == hidden else out[:, :hidden].contiguous()
