"""The port's trainers (poreplex_torch.training) against poreplex-tpu's, on
the CPU at small widths: the datasets and the calibration table exactly,
the losses within 1e-6, one train step of each network (loss within 1e-5
relative, every gradient tensor within 1e-4 of its largest JAX element plus
1e-7, one Adam update within 1e-6, the loss after three steps within 1e-3
relative), checkpoints that load in both packages' models, and the
command-line entry points."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poreplex_tpu.models.demux import DemuxModel as JaxDemuxModel
from poreplex_tpu.models.scaler import ScalerModel as JaxScalerModel
from poreplex_tpu.training import calibration as jcalibration
from poreplex_tpu.training import data as jdata
from poreplex_tpu.training import losses as jlosses
from poreplex_tpu.training import train_demux as jdemux
from poreplex_tpu.training import train_scaler as jscaler
from poreplex_torch import weights
from poreplex_torch.models.demux import DemuxModel
from poreplex_torch.models.scaler import ScalerModel
from poreplex_torch.training import calibration, data, layers, losses
from poreplex_torch.training import train_demux, train_scaler

REPO = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4          # of the tensor's largest JAX gradient element
GRAD_ATOL = 1e-7
ADAM_ATOL = 1e-6
STEPS_RTOL = 1e-3
MODEL_ATOL = 5e-5
NOISE_STDDEV = 0.05
quiet = lambda *args: None


def as_numpy(tree, dtype=np.float32):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


# ---------------------------------------------------------------- data

@pytest.mark.parametrize('n_per_class,trim_length,decoy_fraction', [
    (3, 300, 0.2), (5, 64, 0.5)])
def test_demux_dataset_equals_jax(n_per_class, trim_length, decoy_fraction):
    rng_j, rng_t = np.random.RandomState(4), np.random.RandomState(4)
    wj, lj = jdata.demux_dataset(n_per_class, rng_j, trim_length,
                                 decoy_fraction)
    wt, lt = data.demux_dataset(n_per_class, rng_t, trim_length,
                                decoy_fraction)
    assert wt.dtype == wj.dtype and lt.dtype == lj.dtype
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(lt, lj)
    # the generator is left where JAX leaves it, so batches follow alike
    assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)


@pytest.mark.parametrize('n,pooled_length', [(6, 2000), (10, 60)])
def test_scaler_dataset_equals_jax(n, pooled_length):
    rng_j, rng_t = np.random.RandomState(8), np.random.RandomState(8)
    hj, tj = jdata.scaler_dataset(n, rng_j, pooled_length)
    ht, tt = data.scaler_dataset(n, rng_t, pooled_length)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(tt, tj)
    assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)


def write_inventory(path, signals):
    """{read_id: signal} in the dump-inventory layout
    (adapter/<read_id[:3]>/<read_id>), as tests/test_training.py writes
    it."""
    import h5py
    with h5py.File(path, 'w') as h5:
        for read_id, signal in signals.items():
            h5.create_dataset('adapter/{}/{}'.format(read_id[:3], read_id),
                              data=np.asarray(signal, np.float32))


@pytest.fixture
def inventories(tmp_path):
    """One dump inventory per label (decoy, BC1..BC4) of six reads, some
    shorter and some longer than the window: [(path, label)]."""
    pytest.importorskip('h5py')
    rng = np.random.RandomState(1)
    runs = []
    for label in range(5):
        signals = {}
        for i in range(6):
            # un-normalized adapter signal
            length = (120, 300, 450)[i % 3]
            w = jdata.make_adapter_window(rng, label - 1, length)
            signals['{:03x}-read{}-{}'.format(label * 256 + i, label, i)] = \
                w * 5.0 + 80.0
        path = str(tmp_path / 'inv{}.h5'.format(label))
        write_inventory(path, signals)
        runs.append((path, label))
    return runs


def test_adapter_inventory_loaders_equal_jax(inventories):
    runs = list(inventories)
    wj, ids_j = jdata.load_adapter_windows(runs[2][0])
    wt, ids_t = data.load_adapter_windows(runs[2][0])
    assert ids_t == ids_j
    np.testing.assert_array_equal(wt, wj)
    assert (wt[:, 0] == -1000.0).any()          # a padded short signal

    # run 3 restricted to half of its reads
    keep = set(data.load_adapter_windows(runs[3][0])[1][::2])
    runs[3] = runs[3] + (keep,)
    wj, lj = jdata.dumps_dataset(runs, rng=np.random.RandomState(9))
    wt, lt = data.dumps_dataset(runs, rng=np.random.RandomState(9))
    assert wt.shape == (4 * 6 + 3, 300)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize('n,power,seed', [
    (60000, 15, 7),     # multiscale: every window scale, loess, roots
    (5000, 1, 0),       # multiscale: the finest scale only
    (1000, 4, 2),       # multiscale entry, too few windows: fallback
    (999, 4, 2),        # the small-data fallback
    (200, 1, 3),
    (0, 1, 0),
])
def test_calibration_table_equals_jax(n, power, seed):
    rng = np.random.RandomState(seed)
    scores = rng.power(power, n) if power > 1 else rng.uniform(0.2, 1.0, n)
    correct = rng.uniform(size=n) < scores
    want = jcalibration.compute_calibration_table(scores, correct)
    got = calibration.compute_calibration_table(scores, correct)
    assert got.dtype == want.dtype and len(got) == 29
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- losses

def separated_probs(rng, n, classes):
    """Softmax rows whose two largest entries differ by more than 1e-3, so
    the argmax behind the sample weights is the same in both packages."""
    logits = rng.normal(0.0, 3.0, (n, classes))
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    top2 = np.sort(probs, axis=1)[:, -2:]
    keep = top2[:, 1] - top2[:, 0] > 1e-3
    return probs[keep]


@pytest.mark.parametrize('cost_seed', [None, 5])
def test_losses_equal_jax(cost_seed):
    rng = np.random.RandomState(12)
    probs = separated_probs(rng, 96, 5)
    onehot = np.eye(5, dtype=np.float32)[rng.randint(0, 5, len(probs))]
    cost = (train_demux.DEFAULT_COST_MAT if cost_seed is None else
            np.random.RandomState(cost_seed).uniform(0.5, 3.0, (5, 5))
            .astype(np.float32))
    j = [jnp.asarray(a) for a in (onehot, probs, cost)]
    t = [torch.as_tensor(a) for a in (onehot, probs, cost)]
    np.testing.assert_allclose(losses.sample_weights(*t).numpy(),
                               np.asarray(jlosses.sample_weights(*j)),
                               rtol=0, atol=1e-6)
    for name in ('weighted_categorical_crossentropy',
                 'weighted_categorical_accuracy'):
        got = float(getattr(losses, name)(*t))
        want = float(getattr(jlosses, name)(*j))
        assert abs(got - want) <= 1e-6, (name, got, want)

    # the gradient reaches the probabilities through the log only
    p = t[1].clone().requires_grad_()
    losses.weighted_categorical_crossentropy(t[0], p, t[2]).backward()
    want = jax.grad(jlosses.weighted_categorical_crossentropy, argnums=1)(
        *j)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_weighted_loss_matches_reference_semantics():
    """The two-class example of tests/test_training.py: sample weight =
    cost_mat[argmax true, argmax pred] (poreplex/keras_wrap.py:63-79)."""
    cost = torch.tensor([[1., 2.], [3., 4.]])
    y_true = torch.tensor([[1., 0.], [0., 1.]])
    y_pred = torch.tensor([[0.2, 0.8], [0.1, 0.9]])
    np.testing.assert_allclose(
        losses.sample_weights(y_true, y_pred, cost).numpy(), [2.0, 4.0])
    acc = float(losses.weighted_categorical_accuracy(y_true, y_pred, cost))
    assert abs(acc - 4.0 / 6.0) < 1e-6


def test_clip_gradient_at_the_bounds():
    """torch.clamp and jnp.clip agree inside and outside the crossentropy's
    clip; exactly on a bound (float32 1e-7 and 1 - 1e-7) JAX passes half
    the gradient and torch all of it. A saturated softmax reaches the upper
    bound only as that one float32 value."""
    eps = 1e-7
    x = np.array([0.0, eps, 0.3, 1.0 - eps, 1.0], np.float32)
    t = torch.as_tensor(x).requires_grad_()
    torch.clamp(t, eps, 1.0 - eps).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, eps, 1.0 - eps)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy()[[0, 2, 4]],
                                  np.asarray(want)[[0, 2, 4]])
    np.testing.assert_array_equal(t.grad.numpy()[[1, 3]], [1.0, 1.0])
    np.testing.assert_array_equal(np.asarray(want)[[1, 3]], [0.5, 0.5])


# ---------------------------------------------------------- train steps

class DemuxCase:
    """Demux at BiLSTM(8) -> LSTM(16), 8 windows of 48 frames, with the
    noise that JAX's forward draws from its key handed to the port."""
    layers = weights.DEMUX_LAYERS
    net = train_demux.DemuxNet
    frames = 48

    def __init__(self):
        self.params = jdemux.init_params(jax.random.PRNGKey(3), 8, 16)
        rng = np.random.RandomState(21)
        self.windows, self.labels = data.demux_dataset(
            60, rng, trim_length=self.frames)
        self.n = len(self.windows)
        self.rng = rng

    def batch(self, idx, key):
        return self.windows[idx], self.labels[idx], key

    @staticmethod
    def noise(batch):
        """The noise JAX's forward draws from the batch's key."""
        windows, _, key = batch
        noise = NOISE_STDDEV * jax.random.normal(key, windows.shape + (1,))
        return np.array(noise)[..., 0]

    def exact_batch(self, batch):
        """In float64, with the noise added to the windows."""
        return (batch[0] + self.noise(batch).astype(np.float64), batch[1],
                None)

    @staticmethod
    def jax_loss(params, batch):
        windows, labels, key = batch
        probs = jdemux.forward(params, windows, noise_key=key)
        return jlosses.weighted_categorical_crossentropy(
            jax.nn.one_hot(labels, jdemux.NUM_CLASSES), probs,
            jnp.asarray(train_demux.DEFAULT_COST_MAT))

    @staticmethod
    def jax_step(optimizer):
        return jdemux.make_train_step(
            optimizer, jnp.asarray(train_demux.DEFAULT_COST_MAT))

    def torch_args(self, batch):
        return (torch.as_tensor(batch[0]), torch.as_tensor(batch[1]),
                torch.as_tensor(self.noise(batch)),
                torch.as_tensor(train_demux.DEFAULT_COST_MAT))

    @staticmethod
    def torch_loss(net, windows, labels, noise, cost):
        return train_demux.loss(net, windows, labels, cost, noise)

    @staticmethod
    def torch_step(net, optimizer, windows, labels, noise, cost):
        return train_demux.train_step(net, optimizer, windows, labels,
                                      noise, cost)

    def check_batch(self, batch):
        """The sample weights follow the argmax: its margin must be far
        above float32 rounding."""
        probs = np.asarray(jdemux.forward(self.params, batch[0],
                                          noise_key=batch[2]))
        top2 = np.sort(probs, axis=1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-5


class ScalerCase:
    """Scaler at LSTM(16) -> LSTM(16), 8 heads of 60 frames, standardized
    targets."""
    layers = weights.SCALER_LAYERS
    net = train_scaler.ScalerNet

    def __init__(self):
        self.params = jscaler.init_params(jax.random.PRNGKey(5), 16)
        rng = np.random.RandomState(22)
        heads, targets = data.scaler_dataset(40, rng, pooled_length=60)
        self.heads = heads
        self.targets = ((targets - targets.mean(0)) /
                        targets.std(0)).astype(np.float32)
        self.n = len(heads)
        self.rng = rng

    def batch(self, idx, key):
        return self.heads[idx], self.targets[idx]

    @staticmethod
    def exact_batch(batch):
        return tuple(a.astype(np.float64) for a in batch)

    @staticmethod
    def jax_loss(params, batch):
        heads, targets = batch
        return jnp.mean((jscaler.forward(params, heads) - targets) ** 2)

    @staticmethod
    def jax_step(optimizer):
        return jscaler.make_train_step(optimizer)

    def torch_args(self, batch):
        return tuple(torch.as_tensor(a) for a in batch)

    @staticmethod
    def torch_loss(net, heads, targets):
        return train_scaler.loss(net, heads, targets)

    @staticmethod
    def torch_step(net, optimizer, heads, targets):
        return train_scaler.train_step(net, optimizer, heads, targets)

    def check_batch(self, batch):
        pass


CASES = {'demux': DemuxCase, 'scaler': ScalerCase}


@pytest.fixture(scope='module', params=sorted(CASES))
def step_case(request):
    """A case with its first batch, JAX's float32 loss and gradients there
    as its trainer computes them, and the gradients of the same JAX
    functions evaluated in float64."""
    case = CASES[request.param]()
    idx = case.rng.randint(0, case.n, 8)
    case.first = case.batch(idx, jax.random.PRNGKey(11))
    case.check_batch(case.first)
    case.jax_value, case.jax_grads = jax.jit(jax.value_and_grad(
        case.jax_loss))(case.params, case.first)
    exact_batch = case.exact_batch(case.first)   # float32 noise, drawn here
    with jax.enable_x64(True):
        case.exact_grads = as_numpy(jax.jit(jax.grad(case.jax_loss))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), case.params),
            exact_batch), np.float64)
    return case


def test_one_step_loss_and_gradients_equal_jax(step_case):
    """The loss against JAX's at float32; the gradients against JAX's
    functions evaluated in float64, since JAX's float32 gradient of its
    expm1 tanh is wrong above about 9 (test_jax_tanh_gradient_departs),
    which the scaler's raw heads reach in its first layer."""
    case = step_case
    net = case.net.from_params(as_numpy(case.params), 'cpu')
    value = case.torch_loss(net, *case.torch_args(case.first))
    value.backward()
    want = float(case.jax_value)
    assert abs(value.item() - want) <= LOSS_RTOL * abs(want)
    for layer, keys in case.layers.items():
        for key in keys:
            g_jax = case.exact_grads[layer][key]
            g = getattr(net, layer)[key].grad.numpy()
            tol = GRAD_RTOL * np.abs(g_jax).max() + GRAD_ATOL
            err = np.abs(g - g_jax).max()
            assert err <= tol, (layer, key, err, tol)


def test_jax_tanh_gradient_departs():
    """JAX differentiates poreplex-tpu's expm1 tanh, t / (t + 2), by the
    quotient rule, whose two terms cancel badly once t = expm1(2x) is
    large: jitted, its float32 gradient at x = 19.9 is about -1.6e-7, where
    the true value is 2e-17; the port's is within 1e-8 from x = 10 on."""
    from poreplex_torch.ops import rnn
    from poreplex_tpu.ops import rnn as jrnn
    x = np.array([10.0, 15.0, 19.9], np.float32)
    exact = 1.0 / np.cosh(x.astype(np.float64)) ** 2
    g_jax = np.asarray(jax.jit(jax.vmap(jax.grad(jrnn.accurate_tanh)))(
        jnp.asarray(x)))
    assert g_jax[-1] < -1e-7
    t = torch.as_tensor(x).requires_grad_()
    rnn.accurate_tanh(t).sum().backward()
    assert (np.abs(t.grad.numpy() - exact) < 1e-8).all()


def test_one_adam_update_equals_optax(step_case):
    """From identical parameters and gradients (JAX's)."""
    case = step_case
    optimizer = optax.adam(1e-3)
    updates, _ = optimizer.update(case.jax_grads,
                                  optimizer.init(case.params), case.params)
    want = as_numpy(optax.apply_updates(case.params, updates))

    net = case.net.from_params(as_numpy(case.params), 'cpu')
    for layer, keys in case.layers.items():
        for key in keys:
            getattr(net, layer)[key].grad = torch.as_tensor(
                np.asarray(case.jax_grads[layer][key]))
    layers.make_optimizer(net).step()
    got = weights.checkpoint_arrays(net, case.layers)
    for name, value in got.items():
        layer, key = name.split('/')
        np.testing.assert_allclose(value, want[layer][key], rtol=0,
                                   atol=ADAM_ATOL, err_msg=name)


def test_three_steps_follow_jax(step_case):
    """Three steps of each trainer's own step function, on the batches and
    noise keys JAX's train loop draws; then the loss at the parameters
    they reach."""
    case = step_case
    jax_step = case.jax_step(optax.adam(1e-3))
    params = case.params
    opt_state = optax.adam(1e-3).init(params)
    net = case.net.from_params(as_numpy(params), 'cpu')
    optimizer = layers.make_optimizer(net)
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(1)
    for step in range(4):
        idx = rng.randint(0, case.n, 8)
        key, sub = jax.random.split(key)
        batch = case.batch(idx, sub)
        if step == 3:
            want = float(case.jax_loss(params, batch))
            with torch.no_grad():
                got = float(case.torch_loss(net, *case.torch_args(batch)))
        else:
            params, opt_state, want = jax_step(params, opt_state, *batch)
            got = float(case.torch_step(net, optimizer,
                                        *case.torch_args(batch)))
        assert abs(got - float(want)) <= STEPS_RTOL * abs(float(want)), step


# -------------------------------------------------- init and weights

@pytest.mark.parametrize('module,sizes', [
    (train_demux, {'hidden1': 48, 'hidden2': 64}),
    (train_scaler, {'hidden': 48})])
def test_init_params_follow_jax_distributions(module, sizes):
    """Orthogonal rows, the uniform limits, the forget-gate bias of 1, and
    JAX's shapes; the values differ by design."""
    params = module.init_params(torch.Generator().manual_seed(0), **sizes)
    jax_module = jdemux if module is train_demux else jscaler
    want = jax_module.init_params(jax.random.PRNGKey(0), **sizes)
    assert jax.tree.map(np.shape, as_numpy(want)) == \
        {layer: {key: tuple(t.shape) for key, t in p.items()}
         for layer, p in params.items()}
    for layer, p in params.items():
        in_dim, out_dim = p['kernel'].shape
        lim = np.sqrt(6.0 / (in_dim + out_dim))
        assert float(p['kernel'].abs().max()) <= lim
        assert float(p['kernel'].abs().max()) > 0.5 * lim
        if 'recurrent' not in p:
            assert not p['bias'].any()
            continue
        r = p['recurrent']
        hidden = r.shape[0]
        err = (r @ r.T - torch.eye(hidden)).abs().max()
        assert float(err) <= 1e-5
        bias = p['bias'].numpy()
        np.testing.assert_array_equal(bias[hidden:2 * hidden], 1.0)
        assert not np.delete(bias, np.s_[hidden:2 * hidden]).any()


def test_weights_carry_jax_parameters_across():
    params = jdemux.init_params(jax.random.PRNGKey(2), 8, 16)
    flat = {'{}/{}'.format(layer, key): np.asarray(value)
            for layer, p in params.items() for key, value in p.items()}
    for source in (params, flat):
        net = train_demux.DemuxNet.from_params(source, 'cpu')
        assert all(p.requires_grad and p.device.type == 'cpu'
                   for p in net.parameters())
        back = weights.checkpoint_arrays(net, weights.DEMUX_LAYERS)
        assert list(back) == [name for name in flat if name in back]
        assert set(back) == set(flat)
        for name, value in back.items():
            assert value.dtype == np.float32
            np.testing.assert_array_equal(value, flat[name])
    state = weights.scaler_state_dict(
        jscaler.init_params(jax.random.PRNGKey(2), 8), 'cpu',
        requires_grad=True)
    assert all(t.requires_grad and t.is_leaf for t in state.values())


# -------------------------------------------------------- checkpoints

def load_npz(path):
    with np.load(path) as f:
        return {name: f[name] for name in f.files}


def test_checkpoints_equal_jax_checkpoints(tmp_path):
    """Same keys in the same order, same dtypes, same array bytes; the
    scaler's meta is the same JSON bytes."""
    demux_params = jdemux.init_params(jax.random.PRNGKey(6), 8, 16)
    calib = np.linspace(0.0, 1.0, 29)
    jdemux.save_checkpoint(str(tmp_path / 'j.npz'), demux_params, calib,
                           jdemux.DEFAULT_COST_MAT)
    train_demux.save_checkpoint(
        str(tmp_path / 't.npz'),
        train_demux.DemuxNet.from_params(as_numpy(demux_params), 'cpu'),
        calib, train_demux.DEFAULT_COST_MAT)

    scaler_params = jscaler.init_params(jax.random.PRNGKey(6), 8)
    transform = {'scale_mean': 0.955, 'scale_std': 0.074,
                 'shift_mean': 5.5, 'shift_std': 5.46}
    jscaler.save_checkpoint(str(tmp_path / 'js.npz'), scaler_params,
                            transform, train_scaler.INPUT_DEFS)
    train_scaler.save_checkpoint(
        str(tmp_path / 'ts.npz'),
        train_scaler.ScalerNet.from_params(as_numpy(scaler_params), 'cpu'),
        transform, train_scaler.INPUT_DEFS)

    for jname, tname in (('j.npz', 't.npz'), ('js.npz', 'ts.npz')):
        want = load_npz(tmp_path / jname)
        got = load_npz(tmp_path / tname)
        assert list(got) == list(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].shape == want[name].shape, name
            assert got[name].tobytes() == want[name].tobytes(), name
    assert json.loads(bytes(got['meta']))['output_transform'] == transform


@pytest.fixture(scope='module')
def demux_windows():
    rng = np.random.RandomState(31)
    windows, _ = data.demux_dataset(2, rng)
    return windows[:6]


def assert_demux_models_agree(path, windows):
    port = DemuxModel(path, device='cpu')
    with torch.no_grad():
        got = port(torch.as_tensor(windows)).numpy()
    want = np.asarray(JaxDemuxModel(path)._apply(jnp.asarray(windows)))
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_ATOL)
    labels, scores = port.predict(windows)
    assert labels.shape == (len(windows),)
    assert len(port.calibration_table) == 29


def assert_scaler_models_agree(path, heads):
    port = ScalerModel(path, device='cpu')
    got, got_qc = port.predict(heads)
    jax_model = JaxScalerModel(path)
    want, want_qc = jax_model.predict(heads)
    std = jax_model.xfrm[:, 0]
    np.testing.assert_allclose(got / std, want / std, rtol=0,
                               atol=MODEL_ATOL)
    np.testing.assert_array_equal(got_qc, want_qc)


def test_train_demux_checkpoint_loads_in_both_packages(tmp_path,
                                                       demux_windows):
    path = str(tmp_path / 'demux.npz')
    acc = train_demux.train(path, steps=2, batch_size=8, n_per_class=4,
                            log=quiet, device='cpu')
    assert 0.0 <= acc <= 1.0
    assert_demux_models_agree(path, demux_windows)


def test_train_scaler_checkpoint_loads_in_both_packages(tmp_path):
    rng = np.random.RandomState(3)
    heads, targets = data.scaler_dataset(30, rng, pooled_length=60)
    path = str(tmp_path / 'scaler.npz')
    stats = train_scaler.train(path, steps=2, batch_size=8,
                               data=(heads, targets), log=quiet,
                               device='cpu')
    assert set(stats) == {'scale', 'shift'}
    meta = json.loads(bytes(np.load(path)['meta']))
    assert meta['input'] == train_scaler.INPUT_DEFS
    assert_scaler_models_agree(path, heads[:5])


def test_jax_checkpoints_load_in_the_port(tmp_path, demux_windows):
    demux_path = str(tmp_path / 'demux.npz')
    jdemux.save_checkpoint(
        demux_path, jdemux.init_params(jax.random.PRNGKey(8)),
        np.linspace(0.0, 1.0, 29), jdemux.DEFAULT_COST_MAT)
    assert_demux_models_agree(demux_path, demux_windows)
    scaler_path = str(tmp_path / 'scaler.npz')
    jscaler.save_checkpoint(
        scaler_path, jscaler.init_params(jax.random.PRNGKey(8)),
        {'scale_mean': 0.955, 'scale_std': 0.074, 'shift_mean': 5.5,
         'shift_std': 5.46}, train_scaler.INPUT_DEFS)
    heads, _ = data.scaler_dataset(4, np.random.RandomState(5),
                                   pooled_length=60)
    assert_scaler_models_agree(scaler_path, heads)


# -------------------------------------------------------- entry points

def test_train_demux_from_dumps(tmp_path, inventories):
    path = str(tmp_path / 'demux.npz')
    args = ['--cpu', '-o', path, '--steps', '1', '--batch-size', '4']
    for (inventory, label), name in zip(inventories,
                                        train_demux.LABEL_IDS):
        assert train_demux.LABEL_IDS[name] == label
        args += ['--dumps', '{}={}'.format(name, inventory)]
    train_demux.main(args)
    assert len(np.load(path)['calibration']) == 29


def test_train_demux_command_line_on_the_cpu(tmp_path):
    path = tmp_path / 'demux.npz'
    # two intra-op threads: the suite's workers share the host's cores,
    # and a subprocess of spinning threads on every core crawls beside them
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='2')
    out = subprocess.run(
        [sys.executable, '-m', 'poreplex_torch.training.train_demux',
         '--cpu', '-o', str(path), '--steps', '2', '--batch-size', '8'],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'eval accuracy' in out.stdout
    assert len(np.load(path)['calibration']) == 29


@pytest.mark.parametrize('module', [train_demux, train_scaler])
def test_trainers_want_cuda_by_default(tmp_path, module):
    assert not torch.cuda.is_available()
    path = str(tmp_path / 'model.npz')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        module.train(path, steps=1, log=quiet)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        module.main(['-o', path, '--steps', '1'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        module.main(['-o', path, '--data-parallel'])
    assert not os.path.exists(path)
