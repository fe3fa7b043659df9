#!/usr/bin/env python3
"""Reads the loops of the port's CUDA kernels from their SASS.

    python3 kernel_sass.py [--out build/kernel_sass]
    python3 kernel_sass.py --lstm-widths

Builds each source of ``poreplex_torch/csrc`` as the package does at first
use, writes its SASS (``cuobjdump -sass``) to ``<out>/<source>.sass`` and
prints, for every kernel, its innermost loops: their first and last
address, their instructions, their float compares (``FSETP``: a step of
the peak detector's state machine, or a gate's range check), the branches
inside them other than the back edge and their calls (``CALL``: an IEEE
division's slow path is one). A loop that compares floats and holds no
other branch runs converged whatever each lane's data: the peak
detector's two frame loops and the Viterbi kernels' forward and backtrace
loops are such loops, and hold no call. The loops also go to
``<out>/kernel_sass.json``. Each kernel's registers and spills
(``-Xptxas -v``) are printed by instantiation, and the general LSTM
design's instantiations (``lstm_general_kernel``,
``lstm2_stacked_general_kernel``, compiled for the block sizes
``kernels/lstm.py``'s plan() picks, at most ``G_MAX_THREADS`` and two
``G_LAYER_THREADS``) must not spill: the script exits 1 if one does.

``--lstm-widths`` instead compiles ``csrc/lstm.cu`` with wider lists of the
register design's widths (``PROBE_WIDTHS``, defined before the source is
included) and prints each instantiation's registers and spills: a width
that spills is one the package must not instantiate. Needs the CUDA
toolkit, not a card.
"""

import argparse
import json
import os
import re
import subprocess
import sys

# csrc/lstm.cu's width lists, one width past each instantiated one
PROBE_WIDTHS = {'STACKED_WIDTHS': (48, 64), 'SEQ_WIDTHS': (64, 80),
                'LAST_WIDTHS': (64, 80)}
FUNCTION = re.compile(r'Function : (\S+)\n(.*?)(?=Function :|\Z)', re.S)
INSTRUCTION = re.compile(r'^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;', re.M)
BRANCH = re.compile(r'\bBRA(?:\.\S+)?\b.*?(0x[0-9a-f]+)\s*$')
CALL = re.compile(r'\bCALL\b')
GENERAL_LSTM = ('lstm_general_kernel', 'lstm2_stacked_general_kernel')


def instructions(body):
    """[(address, text)] of one function's SASS listing."""
    return [(int(a, 16), text) for a, text in INSTRUCTION.findall(body)]


def innermost_loops(code):
    """The loops of [(address, text)] that hold no other loop: each a dict
    of its first and last address (the back edge), its instructions, its
    float compares, its branches other than the back edge and its
    calls."""
    targets = {}
    for address, text in code:
        m = BRANCH.search(text)
        if m:
            targets[address] = int(m.group(1), 16)
    loops = sorted((t, a) for a, t in targets.items() if t < a)
    found = []
    for start, end in loops:
        if any((s, e) != (start, end) and start <= s and e <= end
               for s, e in loops):
            continue
        body = [(a, text) for a, text in code if start <= a <= end]
        found.append(dict(
            first=hex(start), last=hex(end), instructions=len(body),
            float_compares=sum('FSETP' in text for _, text in body),
            inner_branches=sum(a in targets for a, _ in body if a != end),
            calls=sum(bool(CALL.search(text)) for _, text in body)))
    return found


def read(text):
    """{kernel: innermost loops} of a cuobjdump -sass listing."""
    return {name: innermost_loops(instructions(body))
            for name, body in FUNCTION.findall(text)}


def general_lstm_usage(report):
    """({label: (registers, stack, spill stores, spill loads)} of the
    general LSTM instantiations in csrc/lstm.cu's -Xptxas -v report, the
    labels of those that spill)."""
    from poreplex_torch.kernels import _build
    usage = {label: u for label, u in _build.ptxas_usage(report).items()
             if label.split('<')[0] in GENERAL_LSTM}
    return usage, sorted(label for label, u in usage.items() if u[2] or u[3])


def lstm_report(out, widths=None):
    """nvcc's resource report of csrc/lstm.cu built as the package builds
    it, with the register design's width lists ``widths`` ({list name:
    widths}) defined first when given."""
    from poreplex_torch.kernels import _build
    os.makedirs(out, exist_ok=True)
    source = os.path.join(os.path.abspath(out), 'lstm_{}.cu'.format(
        'widths' if widths else 'check'))
    with open(source, 'w') as f:
        for name, listed in (widths or {}).items():
            f.write('#define {}(X) {}\n'.format(
                name, ' '.join('X({})'.format(w) for w in listed)))
        f.write('#include "{}"\n'.format(
            os.path.join(_build.CSRC_DIR, 'lstm.cu')))
    proc = subprocess.run(
        [_build.nvcc_path()] + _build.flags('lstm.cu') +
        ['-o', source[:-3] + '.so', source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed:\n' + proc.stdout + proc.stderr)
    return proc.stdout + proc.stderr


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', default=os.path.join('build',
                                                      'kernel_sass'))
    parser.add_argument('--lstm-widths', action='store_true')
    opts = parser.parse_args()
    from poreplex_torch.kernels import _build
    if opts.lstm_widths:
        print('\n'.join(_build.usage_lines(
            'lstm.cu', lstm_report(opts.out, PROBE_WIDTHS))))
        return 0
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), 'cuobjdump')
    os.makedirs(opts.out, exist_ok=True)
    result = {}
    reports = _build.build_all()
    for source, report in reports.items():
        text = subprocess.run([tool, '-sass', _build.library_path(source)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = os.path.splitext(source)[0]
        with open(os.path.join(opts.out, name + '.sass'), 'w') as f:
            f.write(text)
        print('\n'.join(_build.usage_lines(source, report)))
        for kernel, loops in read(text).items():
            result[kernel] = loops
            print(kernel)
            for loop in loops:
                print('  loop {first}..{last}: {instructions} instructions, '
                      '{float_compares} FSETP, {inner_branches} branches '
                      'besides the back edge, {calls} calls'.format(**loop))
    with open(os.path.join(opts.out, 'kernel_sass.json'), 'w') as f:
        json.dump(result, f, indent=1)
    from poreplex_torch.kernels import lstm as klstm
    usage, spilling = general_lstm_usage(lstm_report(opts.out))
    print('general LSTM design (blocks of at most {} and {} threads): {}; '
          '{}'.format(klstm.G_MAX_THREADS, 2 * klstm.G_LAYER_THREADS,
                      ', '.join('{} {} registers'.format(label, u[0])
                                for label, u in sorted(usage.items())),
                      'spills: ' + ', '.join(spilling) if spilling
                      else 'no spill'))
    return 1 if spilling or not usage else 0


if __name__ == '__main__':
    sys.exit(main())
