"""Data-parallel training (poreplex_torch/parallel/training.py) on the CPU:
gloo ranks, each a process with its own bound on its run (RANK_TIMEOUT).

At small widths (test_torch_training's cases: demux BiLSTM(8) -> LSTM(16)
on 8 windows of 48 frames, scaler LSTM(16) -> LSTM(16) on 8 heads of 60
frames), two ranks' first step (the loss and the gradients after the
all-reduce) equals the port's one-process step on the same global batch
and noise (loss within 1e-6 relative, each gradient within 1e-6 of its
tensor's largest element) and JAX's mesh step on two CPU devices (at
test_torch_training's tolerances). The demux's first batch gives the two
shards different weight sums, so the mean of the shards' own weighted
losses misses the global loss: a rank's loss is its share of the global
one. After three steps every rank holds the same parameters, every entry
within 3 lr of one process's and the loss there within 1e-6 relative of
the loss at one process's (PARAMS_BOUND says why). The trainers round the
batch and draw their indices as the JAX trainers do on a mesh of 2, 3 and
4 devices, and ``train(devices=[cpu, cpu])`` equals ``train()``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poreplex_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                        replicated_sharding)
from poreplex_tpu.training import train_demux as jdemux
from poreplex_torch import weights
from poreplex_torch.parallel import training
from poreplex_torch.training import data, layers, train_demux, train_scaler

from test_torch_distributed import RANK_TIMEOUT
from test_torch_training import (CASES, GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                                 as_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
STEPS = 3
RANK_LOSS_RTOL = 1e-6
RANK_GRAD_RTOL = 1e-6     # of the tensor's largest one-process element
# Adam moves an entry by about lr (1e-3) a step whatever its gradient's
# size, so an entry whose gradient is a cancellation left near zero by
# float32 rounding (the scaler's first kernel, whose inputs are raw heads
# of some 90 pA) may step either way in either run, where the loss is flat
# in it: after three steps every entry is held within 3 lr of one
# process's, and the loss at the parameters reached within RANK_LOSS_RTOL
PARAMS_BOUND = 3 * 1e-3 * (1 + 1e-3)
quiet = lambda *args: None


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads in this module: the suite runs several workers
    on the host's cores, and torch's spinning thread pools slow every
    process on the host when they oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# one rank of a rank pair: the case's steps from its inputs, then its loss
# and gradients after the first step and its parameters after the last
RANK = '''
import sys
import numpy as np
import torch
from poreplex_torch import weights
from poreplex_torch.parallel import training
from poreplex_torch.training import layers, train_demux, train_scaler
case, rank, world, address, inputs, out = sys.argv[1:]
torch.set_num_threads(2)
module = train_demux if case == 'demux' else train_scaler
layout = weights.DEMUX_LAYERS if case == 'demux' else weights.SCALER_LAYERS
net_class = train_demux.DemuxNet if case == 'demux' else \\
    train_scaler.ScalerNet
replica = training.join(int(rank), int(world), address, 'cpu')
arrays = np.load(inputs)
net = net_class.from_params({name[6:]: arrays[name] for name in arrays.files
                             if name.startswith('param/')}, 'cpu')
optimizer = layers.make_optimizer(net)
saved = {}
for step in range(int(arrays['steps'])):
    args = [torch.as_tensor(arrays['{}/{}'.format(step, k)])
            for k in range(int(arrays['nargs']))]
    value = module.train_step(net, optimizer, *args, replica=replica)
    if step == 0:
        saved['loss'] = value.numpy()
        for layer, keys in layout.items():
            for key in keys:
                saved['grad/{}/{}'.format(layer, key)] = \\
                    getattr(net, layer)[key].grad.numpy()
for name, value in weights.checkpoint_arrays(net, layout).items():
    saved['param/' + name] = value
np.savez(out, **saved)
'''


def run_ranks(work, case_name, params, steps):
    """WORLD rank processes of RANK over ``steps`` (each a list of the
    train step's global arguments as arrays), from ``params`` (flat
    checkpoint names); their outputs by rank."""
    os.makedirs(work, exist_ok=True)
    inputs = os.path.join(work, 'inputs.npz')
    arrays = {'param/' + name: value for name, value in params.items()}
    arrays.update({'{}/{}'.format(step, k): a
                   for step, args in enumerate(steps)
                   for k, a in enumerate(args)})
    np.savez(inputs, steps=len(steps), nargs=len(steps[0]), **arrays)
    address = '127.0.0.1:{}'.format(training.free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    procs, outs = [], []
    for rank in range(WORLD):
        outs.append(os.path.join(work, 'rank{}.npz'.format(rank)))
        procs.append(subprocess.Popen(
            [sys.executable, '-c', RANK, case_name, str(rank), str(WORLD),
             address, inputs, outs[-1]],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, stderr.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for out in outs:
        with np.load(out) as f:
            results.append({name: f[name] for name in f.files})
    return results


def flat_params(case):
    return {'{}/{}'.format(layer, key): np.asarray(value, np.float32)
            for layer, p in case.params.items() for key, value in p.items()}


def weighted_first_batch(case):
    """A demux batch of 8 whose first half (the first rank's rows) is
    decoys, weight 1 each, and whose second half is barcodes that the
    network (with the batch's noise) calls barcodes, weight 2 each: the
    shards' weight sums are 4 and 8. Every row's two largest probabilities
    differ by more than 1e-5, so the weights are the same in both
    packages."""
    key = jax.random.PRNGKey(11)
    noise = case.noise((np.zeros((8, case.frames), np.float32), None, key))
    net = case.net.from_params(as_numpy(case.params), 'cpu')
    rows = list(np.nonzero(case.labels == 0)[0][:4])
    for r in range(4, 8):
        with torch.no_grad():
            probs = net(torch.as_tensor(case.windows),
                        torch.as_tensor(np.repeat(noise[r:r + 1], case.n, 0))
                        ).numpy()
        top2 = np.sort(probs, axis=1)[:, -2:]
        ok = ((case.labels > 0) & (probs.argmax(1) > 0) &
              (top2[:, 1] - top2[:, 0] > 1e-5))
        ok[rows] = False
        rows.append(np.nonzero(ok)[0][0])
    return case.batch(np.asarray(rows), key)


def one_process_steps(case, steps):
    """The port's one-process train_step over ``steps``: (first loss, first
    gradients, final parameters)."""
    net = case.net.from_params(as_numpy(case.params), 'cpu')
    optimizer = layers.make_optimizer(net)
    for step, args in enumerate(steps):
        value = case.torch_step(net, optimizer,
                                *[torch.as_tensor(a) for a in args])
        if step == 0:
            loss = float(value)
            grads = {'{}/{}'.format(layer, key):
                     getattr(net, layer)[key].grad.numpy().copy()
                     for layer, keys in case.layers.items() for key in keys}
    return loss, grads, weights.checkpoint_arrays(net, case.layers)


def jax_mesh_first_step(case, batch, devices):
    """JAX's trainer step with the batch sharded over a mesh of
    ``devices`` and the parameters replicated, as its train() puts them:
    the loss; and the gradients of the same JAX functions in float64."""
    mesh = make_mesh(devices)
    shard = lambda a: jax.device_put(jnp.asarray(a), batch_sharding(mesh))
    repl = replicated_sharding(mesh)
    optimizer = optax.adam(1e-3)
    params = jax.device_put(case.params, repl)
    opt_state = jax.device_put(optimizer.init(case.params), repl)
    mesh_batch = [shard(a) for a in batch[:2]] + list(batch[2:])
    _, _, value = case.jax_step(optimizer)(params, opt_state, *mesh_batch)
    exact_batch = case.exact_batch(batch)      # float32 noise, drawn here
    with jax.enable_x64(True):
        exact = as_numpy(jax.jit(jax.grad(case.jax_loss))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), case.params),
            exact_batch), np.float64)
    return float(value), exact


def make_run(name, tmp_path_factory, cpu_devices):
    case = CASES[name]()
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(1)
    if name == 'demux':
        first = weighted_first_batch(case)
    else:
        first = case.batch(case.rng.randint(0, case.n, 8), None)
    batches = [first]
    for _ in range(STEPS - 1):
        key, sub = jax.random.split(key)
        batches.append(case.batch(rng.randint(0, case.n, 8), sub))
    steps = [[a.numpy() for a in case.torch_args(b)] for b in batches]
    work = str(tmp_path_factory.mktemp('dp-' + name))
    return {
        'name': name, 'case': case, 'first': first, 'steps': steps,
        'ranks': run_ranks(work, name, flat_params(case), steps),
        'one': one_process_steps(case, steps),
        'jax': jax_mesh_first_step(case, first, cpu_devices[:WORLD]),
    }


@pytest.fixture(scope='module')
def demux_run(tmp_path_factory, cpu_devices):
    return make_run('demux', tmp_path_factory, cpu_devices)


@pytest.fixture(scope='module')
def scaler_run(tmp_path_factory, cpu_devices):
    return make_run('scaler', tmp_path_factory, cpu_devices)


@pytest.fixture(params=['demux', 'scaler'])
def run(request):
    return request.getfixturevalue(request.param + '_run')


def test_first_step_equals_one_process(run):
    loss, grads, _ = run['one']
    for rank, out in enumerate(run['ranks']):
        got = float(out['loss'])
        assert abs(got - loss) <= RANK_LOSS_RTOL * abs(loss), (rank, got,
                                                                loss)
        for name, g in grads.items():
            err = np.abs(out['grad/' + name] - g).max()
            assert err <= RANK_GRAD_RTOL * np.abs(g).max(), (rank, name, err)


def test_first_step_equals_jax_mesh_step(run):
    """The loss against JAX's mesh step at float32; the gradients against
    JAX's functions in float64, as test_torch_training holds one
    process's (JAX's float32 gradient of its expm1 tanh departs)."""
    want, exact = run['jax']
    for out in run['ranks']:
        assert abs(float(out['loss']) - want) <= LOSS_RTOL * abs(want)
        for layer, keys in run['case'].layers.items():
            for key in keys:
                g_jax = exact[layer][key]
                err = np.abs(out['grad/{}/{}'.format(layer, key)] -
                             g_jax).max()
                tol = GRAD_RTOL * np.abs(g_jax).max() + GRAD_ATOL
                assert err <= tol, (layer, key, err, tol)


def test_rank_loss_is_a_share_of_the_global_loss(demux_run):
    """The first batch's shards weigh 4 and 8: the mean of the two ranks'
    own weighted means (DDP's averaging of per-shard losses) misses the
    global loss by far more than the tolerance, and the ranks' summed
    loss meets it."""
    case = demux_run['case']
    windows, labels, noise, cost = demux_run['steps'][0]
    net = case.net.from_params(as_numpy(case.params), 'cpu')
    weight_sums, shard_losses = [], []
    with torch.no_grad():
        for rows in (slice(0, 4), slice(4, 8)):
            args = [torch.as_tensor(a[rows]) for a in (windows, labels,
                                                       noise)]
            probs = net(args[0], args[2])
            onehot = torch.nn.functional.one_hot(args[1].long(), 5).float()
            weight_sums.append(float(train_demux.losses.sample_weights(
                onehot, probs, torch.as_tensor(cost)).sum()))
            shard_losses.append(float(train_demux.loss(
                net, args[0], args[1], torch.as_tensor(cost), args[2])))
    assert weight_sums == [4.0, 8.0]
    loss = demux_run['one'][0]
    averaged = np.mean(shard_losses)
    assert abs(averaged - loss) > 100 * RANK_LOSS_RTOL * abs(loss)
    for out in demux_run['ranks']:
        assert abs(float(out['loss']) - loss) <= RANK_LOSS_RTOL * abs(loss)


def test_three_steps_identical_on_every_rank(run):
    """Then the loss at the parameters reached, on each batch of the
    run."""
    case = run['case']
    _, _, want = run['one']
    ranks = [{name[6:]: out[name] for name in out if name.startswith(
        'param/')} for out in run['ranks']]
    for name in want:
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank[name], ranks[0][name],
                                          err_msg=name)
        err = np.abs(ranks[0][name] - want[name]).max()
        assert err <= PARAMS_BOUND, (name, err)
    nets = [case.net.from_params(p, 'cpu') for p in (ranks[0], want)]
    with torch.no_grad():
        for args in run['steps']:
            got, loss = [float(case.torch_loss(
                net, *[torch.as_tensor(a) for a in args])) for net in nets]
            assert abs(got - loss) <= RANK_LOSS_RTOL * abs(loss)


# --------------------------------------------- batches and their indices

class Alone(training.Replica):
    """A rank that has joined no world: its rows only."""

    def broadcast(self, module):
        pass


@pytest.mark.parametrize('world,batch_size', [(2, 9), (3, 10), (4, 2)])
def test_batch_rounding_and_indices_equal_jax(world, batch_size,
                                              cpu_devices, monkeypatch,
                                              tmp_path):
    """The demux trainers over 3 steps on windows that hold their own
    index: JAX's with a mesh of ``world`` CPU devices, the port's as each
    rank of ``world``. Both round the batch alike and draw the same
    indices; the ranks' rows split each batch in order."""
    windows = np.repeat(np.arange(40, dtype=np.float32)[:, None], 8, 1)
    labels = np.arange(40, dtype=np.int32) % 5
    jax_batches = []

    def recording_step(optimizer, cost_mat):
        def step(params, opt_state, windows, labels, key):
            jax_batches.append(np.asarray(windows)[:, 0].astype(int))
            return params, opt_state, jnp.float32(0.0)
        return step

    monkeypatch.setattr(jdemux, 'make_train_step', recording_step)
    jdemux.train(str(tmp_path / 'jax.npz'), steps=3, batch_size=batch_size,
                 data=(windows, labels), mesh=make_mesh(cpu_devices[:world]),
                 log=quiet)

    got = [[] for _ in range(3)]
    for rank in range(world):
        replica = Alone(rank, world)
        steps = []

        def step(net, optimizer, windows, labels, noise, cost_mat,
                 replica=None):
            assert windows.shape == noise.shape
            steps.append(windows[replica.rows(len(windows)), 0].long())
            return torch.zeros(())

        monkeypatch.setattr(train_demux, 'train_step', step)
        train_demux.fit(replica, torch.device('cpu'), quiet,
                        output_path=str(tmp_path / 'torch.npz'), steps=3,
                        batch_size=batch_size, n_per_class=0, seed=0,
                        learning_rate=1e-3, eval_fraction=0.25,
                        data=(windows, labels))
        for k, rows in enumerate(steps):
            got[k].append(rows.numpy())
    assert len(jax_batches) == 3
    assert len(jax_batches[0]) == training.round_batch(batch_size, world)
    for k in range(3):
        assert all(len(rows) == len(got[k][0]) for rows in got[k])
        np.testing.assert_array_equal(np.concatenate(got[k]),
                                      jax_batches[k])


# ----------------------------------------------------------- train()

def held_out(result):
    """The numbers of a trainer's result: the demux's accuracy, the
    scaler's Pearson r and RMSD of each output."""
    if not isinstance(result, dict):
        return [result]
    return [result[name][stat] for name in ('scale', 'shift')
            for stat in ('pearson_r', 'rmsd')]


def test_train_on_two_ranks_equals_one_process(tmp_path, monkeypatch):
    """``train(devices=[cpu, cpu])``, two spawned gloo ranks, against
    ``train()`` in this process, for both trainers at the shipped widths
    on short inputs: the logged losses within RANK_LOSS_RTOL relative, the
    held-out results (from parameters within PARAMS_BOUND) within
    LOSS_RTOL, and the checkpoint's networks within PARAMS_BOUND."""
    monkeypatch.setenv('OMP_NUM_THREADS', '2')     # the spawned ranks'
    rng = np.random.RandomState(3)
    windows, labels = data.demux_dataset(10, rng, trim_length=48)
    heads, targets = data.scaler_dataset(30, rng, pooled_length=60)
    for module, layout, kwargs in (
            (train_demux, weights.DEMUX_LAYERS, dict(data=(windows, labels))),
            (train_scaler, weights.SCALER_LAYERS,
             dict(data=(heads, targets)))):
        results, logs = [], []
        for name, devices in (('one', None), ('two', ['cpu'] * WORLD)):
            lines = []
            results.append(module.train(
                str(tmp_path / name), steps=STEPS, batch_size=8,
                log=lines.append, device='cpu', devices=devices, **kwargs))
            logs.append([float(word) for line in lines
                         for word in line.replace(':', ' ').replace(
                             ';', ' ').split()
                         if word[-1].isdigit() and '.' in word])
        assert len(logs[0]) == len(logs[1]) >= 3
        np.testing.assert_allclose(logs[1], logs[0], rtol=RANK_LOSS_RTOL)
        np.testing.assert_allclose(held_out(results[1]),
                                   held_out(results[0]), rtol=LOSS_RTOL)
        with np.load(str(tmp_path / 'one.npz')) as one, \
                np.load(str(tmp_path / 'two.npz')) as two:
            assert one.files == two.files
            for layer, keys in layout.items():
                for key in keys:
                    name = '{}/{}'.format(layer, key)
                    err = np.abs(two[name] - one[name]).max()
                    assert err <= PARAMS_BOUND, (module.__name__, name, err)


# ------------------------------------------------------- backend checks

def test_backend_of_each_device_list(monkeypatch):
    assert training.backend(['cpu']) == 'gloo'
    assert training.backend([torch.device('cpu')] * 3) == 'gloo'
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        training.backend(['cuda:0'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    with pytest.raises(ValueError, match='cards or on the CPU'):
        training.backend(['cpu', 'cuda:0'])
    monkeypatch.setattr(torch.distributed, 'is_nccl_available',
                        lambda: False)
    with pytest.raises(ValueError, match='NCCL is not available'):
        training.backend(['cuda:0', 'cuda:1'])
    monkeypatch.setattr(torch.distributed, 'is_nccl_available',
                        lambda: True)
    for devices in (['cuda:0', 'cuda:0'], ['cuda'], ['cuda:1', 'cuda:1',
                                                     'cuda:0']):
        with pytest.raises(ValueError, match='named once'):
            training.backend(devices)
    assert training.backend(['cuda:0', 'cuda:1']) == 'nccl'
    with pytest.raises(ValueError, match='at least one device'):
        training.backend([])


def test_rows_split_a_batch_in_order():
    for world in (1, 2, 3, 4):
        batch = training.round_batch(13, world)
        rows = [training.Replica(r, world).rows(batch)
                for r in range(world)]
        assert np.concatenate([np.arange(batch)[s] for s in rows]).tolist() \
            == list(range(batch))
    with pytest.raises(ValueError, match='equal shares'):
        training.Replica(0, 3).rows(10)
