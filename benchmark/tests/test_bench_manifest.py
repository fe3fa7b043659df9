"""BENCHMARK.json and the files it names."""

import json
import os
import re

from benchmark import run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def manifest():
    with open(os.path.join(run.ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_every_named_file_is_found():
    m = manifest()
    for path in m['paths']:
        assert os.path.isdir(os.path.join(run.ROOT, path))
    for config in m['configs']:
        data = run.load_json(config['file'])
        assert data['name'] == config['name']
        # each departure from the source is a key of the file, with its
        # reason there
        assert set(config['reduced']) == set(data['reduced'])
        assert set(config['reduced']) <= set(data)
        assert os.path.isfile(os.path.join(
            run.HERE, 'configs', data['reference_preset']))
    traffic_names = {w['traffic'] for w in m['workloads']}
    for name in traffic_names:
        assert os.path.isfile(os.path.join(run.HERE, 'traffic',
                                           name + '.json'))
    for metric in m['per_layer']:
        assert os.path.isfile(os.path.join(run.HERE, 'metrics',
                                           metric['name'] + '.py'))


def test_names_and_cells():
    m = manifest()
    names = [x['name'] for x in m['configs'] + m['workloads'] +
             m['end_to_end'] + m['per_layer']]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    cells = {w['name'] for w in m['workloads']}
    e2e = {x['name'] for x in m['end_to_end']}
    assert {'reads_per_s', 'setup_s'} == e2e
    for metric in m['per_layer']:
        assert metric['moves'] in e2e
        assert set(metric.get('workloads', cells)) <= cells
    configs = {c['name']: c for c in m['configs']}
    for w in m['workloads']:
        # a card a rank: more than one only for a configuration of ranks
        assert w['chips'] == run.load_json(
            configs[w['config']]['file']).get('ranks', 1)
        assert len(w['why']) <= 200
        _, _, e, p = run.cell_entries(m, w['name'])
        assert {x['name'] for x in e} == e2e and p
    for x in m['end_to_end']:
        assert 0.01 <= x['bound'] <= 0.25
