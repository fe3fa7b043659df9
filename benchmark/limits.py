#!/usr/bin/env python3
"""Readings of the output check's numbers, for setting their limits on
the chip (PERF.md section 2):

    python3 benchmark/limits.py --workload full.mrna --seeds 1 2 3 \
        [--wire-precision fast] [--seconds 5]
    python3 benchmark/limits.py --workload full.mrna --seeds 1 2 3 \
        --polya-bfloat16

The first form makes whole runs in one process (a short window each),
sound or with the program's own 8-bit transport, the control of
``rows_differ_share``; ``--judged-reads 1024`` judges every read of the
pool, which bounds what any seed's sample can read. The second puts the reference with its poly(A)
round in bfloat16 in the program's place, the control of
``dwell_gap_s``, on each seed's judged reads. One JSON line a seed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402
from benchmark.harness import outputs, traffic  # noqa: E402


def bfloat16_control(workload, seed):
    cell, entry, _, _ = run.cell_entries(run.load_manifest(), workload)
    config = run.load_json(entry['file'])
    pool = traffic.make_pool(traffic.load(cell['traffic']))
    sample = run.judged_indices(pool, seed, run.JUDGED_READS,
                                run.JUDGED_FUSED)
    want = run.expected_outputs(config, pool, sample, 'cuda')
    low = run.expected_outputs(config, pool, sample, 'cuda',
                               polya_precision='bfloat16')
    judged = {str(i): i for i in sample}
    rows = {str(i): low[i][0] for i in sample if low[i][0] is not None}
    fastq = {str(i): low[i][1] for i in sample if low[i][1] is not None}
    numbers, fields, _ = outputs.compare(judged, rows, fastq, want)
    return dict(numbers, fields=fields)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True, type=int, nargs='+')
    parser.add_argument('--seconds', default=5, type=int)
    parser.add_argument('--wire-precision', default='exact',
                        choices=('exact', 'fast'))
    parser.add_argument('--judged-reads', default=run.JUDGED_READS,
                        type=int)
    parser.add_argument('--polya-bfloat16', action='store_true')
    args = parser.parse_args()
    for seed in args.seeds:
        if args.polya_bfloat16:
            line = bfloat16_control(args.workload, seed)
        else:
            result = run.run_cell(args.workload, seed, args.seconds,
                                  wire=args.wire_precision,
                                  judged_reads=args.judged_reads)
            line = {k: v['value'] for k, v in result['checks'].items()}
            line['fields'] = result['info']['differing_fields']
            line['differing'] = result['info']['differing_pool_reads']
            line['dwell_pairs'] = result['info']['dwell_pairs']
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              wire=args.wire_precision,
                              polya_bfloat16=args.polya_bfloat16, **line)),
              flush=True)


if __name__ == '__main__':
    main()
