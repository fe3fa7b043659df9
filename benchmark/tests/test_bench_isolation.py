"""Nothing a run imports is JAX or the JAX package, and the reference
imports nothing of the program. Top-level module names are compared
whole: the program's name begins with the JAX package's."""

import ast
import json
import os
import subprocess
import sys

from benchmark import run

REFERENCE = os.path.join(run.HERE, 'reference')


def imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split('.')[0])
    return roots


def test_reference_imports_nothing_of_the_program():
    for fn in os.listdir(REFERENCE):
        if fn.endswith('.py'):
            roots = imported_roots(os.path.join(REFERENCE, fn))
            assert not roots & {'poreplex_torch', 'poreplex_tpu', 'jax',
                                'jaxlib', 'flax'}, fn


def test_a_run_loads_no_jax():
    code = (
        'import sys, json; sys.path.insert(0, {root!r});'
        'from benchmark import run;'
        'import benchmark.harness.source, benchmark.harness.trace,'
        ' benchmark.harness.outputs, benchmark.harness.counts,'
        ' benchmark.reference.pipeline;'
        'import poreplex_torch.commandline, poreplex_torch.pipeline.session,'
        ' poreplex_torch.pipeline.analyzer;'
        'print(json.dumps(run.forbidden_modules()))').format(root=run.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'jaxtyping_like', sys)
    assert 'jax' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert 'jax' in run.forbidden_modules()


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='-1')
    out = subprocess.run(
        [sys.executable, os.path.join(run.HERE, 'run.py'), '--workload',
         'demux.mrna', '--seed', '1', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA' in out.stderr
