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
``G_LAYER_THREADS``), the register design's (``lstm2_stacked_kernel``,
``bilstm_kernel``, ``lstm_last_kernel``) and every Viterbi instantiation
(``viterbi_extents_kernel``, ``viterbi_path_kernel``) must not spill, every
instantiation of the Viterbis' general design (all but the shipped HMMs'
``<6,1>`` and ``<6,2>``, which keep their registers) must fit four blocks
an SM in registers (the 512 blocks of 1,024 windows in one wave:
``viterbi_register_limit``), and
each Viterbi instantiation's forward and backtrace step loops (the chain
warp's: maxima or shifts of values in shared memory, nothing from device
memory, no special function; ``step_loops``) must be found and hold no
branch besides the back edge and no call: the script exits 1 otherwise.

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

# csrc/lstm.cu's width lists, one width past each instantiated one (the
# BiLSTM's widths are multiples of 8)
PROBE_WIDTHS = {'STACKED_WIDTHS': (48, 64), 'SEQ_WIDTHS': (48, 56, 64, 72),
                'LAST_WIDTHS': (64, 80)}
FUNCTION = re.compile(r'Function : (\S+)\n(.*?)(?=Function :|\Z)', re.S)
INSTRUCTION = re.compile(r'^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;', re.M)
BRANCH = re.compile(r'\bBRA(?:\.\S+)?\b.*?(0x[0-9a-f]+)\s*$')
CALL = re.compile(r'\bCALL\b')
GENERAL_LSTM = ('lstm_general_kernel', 'lstm2_stacked_general_kernel')
REGISTER_LSTM = ('lstm2_stacked_kernel', 'bilstm_kernel', 'lstm_last_kernel')
VITERBI = ('viterbi_extents_kernel', 'viterbi_path_kernel')
# opcodes that keep a loop out of the Viterbi chain's step loops: device
# memory and the special-function unit (the workers' loops have them)
OFF_CHAIN = {'LDG', 'STG', 'LDGSTS', 'RED', 'ATOM', 'MUFU'}


def instructions(body):
    """[(address, text)] of one function's SASS listing."""
    return [(int(a, 16), text) for a, text in INSTRUCTION.findall(body)]


def innermost_bodies(code):
    """[(dict, body)] of the loops of [(address, text)] that hold no other
    loop: the dict of its first and last address (the back edge), its
    instructions, its float compares, its branches other than the back
    edge and its calls; the body its [(address, text)]."""
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
        found.append((dict(
            first=hex(start), last=hex(end), instructions=len(body),
            float_compares=sum('FSETP' in text for _, text in body),
            inner_branches=sum(a in targets for a, _ in body if a != end),
            calls=sum(bool(CALL.search(text)) for _, text in body)), body))
    return found


def innermost_loops(code):
    """The dicts of innermost_bodies(code)."""
    return [loop for loop, _ in innermost_bodies(code)]


def opcode(text):
    """'LDS' for '@!P0 LDS.128 R4, [R2]'."""
    words = text.split()
    if words and words[0].startswith('@'):
        words = words[1:]
    return words[0].split('.')[0] if words else ''


def loop_kind(body):
    """'forward' for a loop of the Viterbi chain's forward steps (float
    maxima, FMNMX, and no float compare, of values in shared memory),
    'backtrace' for one of its backtrace steps (shifts of words in shared
    memory stored back there), None for any other loop: one that touches
    device memory or the special-function unit is the workers'."""
    ops = {opcode(text) for _, text in body}
    if ops & OFF_CHAIN:
        return None
    if 'FMNMX' in ops:
        return 'forward' if 'FSETP' not in ops else None
    if 'SHF' in ops and 'STS' in ops:
        return 'backtrace'
    return None


def step_loops(text):
    """{Viterbi kernel label: {'forward': [loop], 'backtrace': [loop]}} of
    a cuobjdump -sass listing, each loop a dict of innermost_bodies."""
    from poreplex_torch.kernels import _build
    found = {}
    for name, body in FUNCTION.findall(text):
        label = _build.kernel_label(name)
        if label.split('<')[0] not in VITERBI:
            continue
        kinds = found.setdefault(label, {'forward': [], 'backtrace': []})
        for loop, code in innermost_bodies(instructions(body)):
            kind = loop_kind(code)
            if kind:
                kinds[kind].append(loop)
    return found


def unclean_step_loops(found):
    """The Viterbi kernels of step_loops(...) missing a forward or a
    backtrace loop, or holding a branch besides a back edge or a call in
    one."""
    return sorted(label for label, kinds in found.items()
                  if not kinds['forward'] or not kinds['backtrace'] or any(
                      loop['inner_branches'] or loop['calls']
                      for loops in kinds.values() for loop in loops))


def read(text):
    """{kernel: innermost loops} of a cuobjdump -sass listing."""
    return {name: innermost_loops(instructions(body))
            for name, body in FUNCTION.findall(text)}


def viterbi_register_limit(blocks=4, registers=65536, unit=8):
    """The most registers a thread of a Viterbi block may take for
    ``blocks`` blocks an SM: an SM's ``registers`` over the blocks'
    threads, allocated ``unit`` a thread at a time."""
    from poreplex_torch.kernels import viterbi as kvit
    return registers // (blocks * kvit.THREADS) // unit * unit


def usage_of(report, kernels):
    """({label: (registers, stack, spill stores, spill loads)} of the
    instantiations of ``kernels`` in an -Xptxas -v report, the labels of
    those that spill)."""
    from poreplex_torch.kernels import _build
    usage = {label: u for label, u in _build.ptxas_usage(report).items()
             if label.split('<')[0] in kernels}
    return usage, sorted(label for label, u in usage.items() if u[2] or u[3])


def source_report(out, source, widths=None):
    """nvcc's resource report of csrc/``source`` built as the package
    builds it, with the register design's width lists ``widths`` ({list
    name: widths}) defined first when given."""
    from poreplex_torch.kernels import _build
    os.makedirs(out, exist_ok=True)
    path = os.path.join(os.path.abspath(out), '{}_{}.cu'.format(
        os.path.splitext(source)[0], 'widths' if widths else 'check'))
    with open(path, 'w') as f:
        for name, listed in (widths or {}).items():
            f.write('#define {}(X) {}\n'.format(
                name, ' '.join('X({})'.format(w) for w in listed)))
        f.write('#include "{}"\n'.format(
            os.path.join(_build.CSRC_DIR, source)))
    proc = subprocess.run(
        [_build.nvcc_path()] + _build.flags(source) +
        ['-o', path[:-3] + '.so', path], capture_output=True, text=True)
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
            'lstm.cu', source_report(opts.out, 'lstm.cu', PROBE_WIDTHS))))
        return 0
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), 'cuobjdump')
    os.makedirs(opts.out, exist_ok=True)
    result, steps = {}, {}
    reports = _build.build_all()
    for source, report in reports.items():
        text = subprocess.run([tool, '-sass', _build.library_path(source)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = os.path.splitext(source)[0]
        with open(os.path.join(opts.out, name + '.sass'), 'w') as f:
            f.write(text)
        print('\n'.join(_build.usage_lines(source, report)))
        steps.update(step_loops(text))
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
    lstm_report = source_report(opts.out, 'lstm.cu')
    usage, spilling = usage_of(lstm_report, GENERAL_LSTM)
    print('general LSTM design (blocks of at most {} and {} threads): {}; '
          '{}'.format(klstm.G_MAX_THREADS, 2 * klstm.G_LAYER_THREADS,
                      ', '.join('{} {} registers'.format(label, u[0])
                                for label, u in sorted(usage.items())),
                      'spills: ' + ', '.join(spilling) if spilling
                      else 'no spill'))
    rusage, rspilling = usage_of(lstm_report, REGISTER_LSTM)
    print('register LSTM design: {}; {}'.format(
        ', '.join('{} {} registers'.format(label, u[0])
                  for label, u in sorted(rusage.items())),
        'spills: ' + ', '.join(rspilling) if rspilling else 'no spill'))
    vusage, vspilling = usage_of(source_report(opts.out, 'viterbi.cu'),
                                 VITERBI)
    from poreplex_torch.kernels import viterbi as kvit
    limit = viterbi_register_limit()
    shipped = ['<{},{}>'.format(*k) for k in kvit.SHIPPED]
    vwide = sorted(label for label, u in vusage.items()
                   if u[0] > limit and label[label.index('<'):] not in shipped)
    print('Viterbi instantiations: {}; {}; {}'.format(
        ', '.join('{} {} registers'.format(label, u[0])
                  for label, u in sorted(vusage.items())),
        'spills: ' + ', '.join(vspilling) if vspilling else 'no spill',
        'general design past {} registers (fewer than four blocks an SM): '
        '{}'.format(limit, ', '.join(vwide)) if vwide else
        'the general design\'s within {} registers (four blocks an SM)'.format(
            limit)))
    for label, kinds in sorted(steps.items()):
        print('{}: {}'.format(label, '; '.join(
            '{} step loops {}'.format(kind, ', '.join(
                '{first}..{last} ({inner_branches} branches besides the back '
                'edge, {calls} calls)'.format(**loop) for loop in loops)
                or 'not found') for kind, loops in kinds.items())))
    unclean = unclean_step_loops(steps)
    print('Viterbi step loops: {}'.format(
        'not found or not clean in ' + ', '.join(unclean) if unclean else
        'every instantiation\'s forward and backtrace loops found, with no '
        'branch besides the back edge and no call'))
    failed = (spilling or not usage or rspilling or not rusage or
              vspilling or vwide or not vusage or unclean or not steps)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
