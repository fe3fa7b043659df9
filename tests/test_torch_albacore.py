"""poreplex_torch.basecall_albacore against poreplex_tpu.basecall_albacore
with a stand-in albacore: ``prepare_albacore`` writes the same
configuration and keeps the version gate, ``AlbacoreBroker.basecall``
passes albacore the same data and returns equal dicts and event tables.
(Both command lines without albacore, mappy or pysam:
tests/test_torch_commandline.py.)

``install_albacore`` puts the stand-in (``__version__``, ``MIN_QSCORE``,
``config_utils``, ``path_utils``, ``config_selector``,
``pipeline_core.PipelineCore``) in sys.modules through a MonkeyPatch, which
undoes it after the test; the command-line and whole-session tests (tests/
test_torch_commandline.py, tests/test_torch_host_stages.py) use it too."""

import configparser
import sys
import types

import numpy as np
import pytest

from poreplex_tpu import basecall_albacore as jax_albacore
from poreplex_torch import basecall_albacore

# albacore's configuration template, as choose_config finds it
TEMPLATE = """\
[pipeline]
basecall_type = 1d
reverse_direction = true

[basecaller]
model = template_rna_r9.4_70bps.jsn
min_qscore = 7
kmer_size = 5
"""


def install_albacore(monkeypatch, datadir, basecaller, version='2.3.4'):
    """A stand-in albacore package in sys.modules. ``basecaller(name,
    rawdata, meta)`` gives PipelineCore's results for one read (a list of
    dicts, empty for no basecall) or raises. Returns the package; its
    ``calls`` lists each (name, rawdata, meta) passed and ``chosen`` each
    choose_config (data path, flowcell, kit)."""
    datadir.mkdir(parents=True, exist_ok=True)
    cfg = datadir / 'r941_70bps_rna.cfg'
    cfg.write_text(TEMPLATE)

    package = types.ModuleType('albacore')
    package.__path__ = []
    package.__version__ = version
    package.MIN_QSCORE = 7
    package.calls = []
    package.chosen = []

    def choose_config(data_path, flowcell, kit):
        package.chosen.append((data_path, flowcell, kit))
        return str(cfg), 'r941_70bps_rna'

    class PipelineCore:
        def __init__(self, configpath, workers):
            assert workers == 0
            self.configpath = configpath
            self.results = []

        def pass_data(self, name, rawdata, meta):
            package.calls.append((name, np.array(rawdata), dict(meta)))
            self.results = basecaller(name, rawdata, meta)

        def finish_all_jobs(self):
            pass

        def get_results(self):
            results, self.results = self.results, []
            return results

    submodules = {
        'config_utils': dict(get_barcoding_options=lambda *args: {}),
        'path_utils': dict(get_default_path=lambda default, argv:
                           str(datadir)),
        'config_selector': dict(choose_config=choose_config),
        'pipeline_core': dict(PipelineCore=PipelineCore),
    }
    monkeypatch.setitem(sys.modules, 'albacore', package)
    for name, attrs in submodules.items():
        module = types.ModuleType('albacore.' + name)
        module.__dict__.update(attrs)
        setattr(package, name, module)
        monkeypatch.setitem(sys.modules, 'albacore.' + name, module)
    return package


EVENT_DTYPE = np.dtype([
    ('mean', '<f4'), ('start', '<i8'), ('stdv', '<f4'), ('length', '<i8'),
    ('model_state', 'S5'), ('move', '<i4'), ('weights', '<f4'),
    ('p_model_state', '<f4'), ('mp_state', 'S5'), ('p_mp_state', '<f4'),
    ('p_A', '<f4'), ('p_C', '<f4'), ('p_G', '<f4'), ('p_T', '<f4')])


def albacore_result(sequence, qstring, events, mean_qscore=11.25):
    """PipelineCore's result for an RNA basecall: albacore calls the
    signal 3' to 5' in the DNA alphabet."""
    return {'sequence': sequence.replace('U', 'T')[::-1],
            'qstring': qstring[::-1], 'mean_qscore': mean_qscore,
            'events': events}


def random_events(rng, n):
    events = np.zeros(n, EVENT_DTYPE)
    for name in EVENT_DTYPE.names:
        if EVENT_DTYPE[name].kind == 'f':
            events[name] = rng.uniform(60, 120, n)
        elif EVENT_DTYPE[name].kind == 'i':
            events[name] = rng.integers(0, 2, n)
    events['start'] = np.cumsum(rng.integers(5, 40, n))
    events['model_state'] = [b'ACGTT'] * n
    return events


def tables_equal(a, b):
    return (sorted(a._cols) == sorted(b._cols) and
            all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                for k in a._cols))


@pytest.mark.parametrize('version', ['2.3.0', '2.3.4', '3.1.2'])
def test_prepare_writes_the_same_configuration(version, tmp_path,
                                               monkeypatch):
    written = []
    for module in (jax_albacore, basecall_albacore):
        package = install_albacore(monkeypatch, tmp_path / 'data',
                                   lambda *args: [], version)
        path = tmp_path / (module.__name__ + '.cfg')
        assert module.albacore_available()
        assert module.prepare_albacore(str(path), 'FLO-MIN106',
                                       'SQK-RNA001') == version
        assert package.chosen == [(str(tmp_path / 'data'), 'FLO-MIN106',
                                   'SQK-RNA001')]
        written.append(path.read_text())
    assert written[0] == written[1]
    parser = configparser.ConfigParser(interpolation=None)
    parser.read_string(written[1])
    assert parser['basecaller']['min_qscore'] == '0'
    assert parser['basecaller']['model'] == 'template_rna_r9.4_70bps.jsn'


@pytest.mark.parametrize('version', ['2.2.7', '1.9.0'])
def test_old_albacore_refused(version, tmp_path, monkeypatch):
    errors = []
    for module in (jax_albacore, basecall_albacore):
        install_albacore(monkeypatch, tmp_path / 'data', lambda *args: [],
                         version)
        with pytest.raises(RuntimeError, match='albacore >= 2.3.0') as exc:
            module.prepare_albacore(str(tmp_path / 'x.cfg'), 'FLO-MIN106',
                                    'SQK-RNA001')
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_absent_albacore_is_unavailable(monkeypatch):
    monkeypatch.setitem(sys.modules, 'albacore', None)
    assert not jax_albacore.albacore_available()
    assert not basecall_albacore.albacore_available()


class Reader:
    channel_number = '417'
    start_time = 123456
    duration = 4000
    sampling_rate = 3012.0


@pytest.mark.parametrize('n_events', [0, 1, 57])
def test_broker_gives_equal_basecalls(n_events, tmp_path, monkeypatch):
    rng = np.random.default_rng(n_events)
    events = random_events(rng, n_events)
    sequence = ''.join(rng.choice(list('ACGU'), n_events + 3))
    qstring = ''.join(chr(33 + q) for q in rng.integers(2, 40,
                                                        len(sequence)))
    rawdata = rng.normal(90, 10, 4000).astype(np.float32)
    outputs = []
    for module in (jax_albacore, basecall_albacore):
        package = install_albacore(
            monkeypatch, tmp_path / 'data',
            lambda *args: [albacore_result(sequence, qstring, events)])
        broker = module.AlbacoreBroker(str(tmp_path / 'x.cfg'), 5)
        assert broker.core.configpath == str(tmp_path / 'x.cfg')
        outputs.append((broker.basecall(rawdata, Reader(), 'read007'),
                        package.calls))
    (ref, ref_calls), (got, calls) = outputs
    assert got.keys() == ref.keys()
    for key in got:
        if key == 'events':
            assert tables_equal(got[key], ref[key])
        else:
            assert got[key] == ref[key], key
    assert got['sequence'] == sequence and got['qstring'] == qstring
    assert got['called_events'] == len(got['events']) == n_events
    assert [c[0] for c in calls] == [c[0] for c in ref_calls] == ['read007']
    assert calls[0][2] == ref_calls[0][2] == {
        'channel_id': '417', 'start_time': 123456, 'duration': 4000,
        'sampling_rate': 3012.0}
    assert calls[0][1].tobytes() == ref_calls[0][1].tobytes() == \
        rawdata.tobytes()


def test_broker_gives_none_without_results(tmp_path, monkeypatch):
    for module in (jax_albacore, basecall_albacore):
        install_albacore(monkeypatch, tmp_path / 'data', lambda *args: [])
        broker = module.AlbacoreBroker(str(tmp_path / 'x.cfg'), 5)
        assert broker.basecall(np.zeros(10, np.float32), Reader(),
                               'r') is None
