"""Several processes (ranks) over one run, the counterpart of poreplex-tpu's
``parallel/distributed.py``.

Every rank runs its own session over the reads it owns, a stable CRC32
slice of the (filename, read_id) entries, and writes its own output
directory. At the end the ranks' final count matrices are summed in one
int64 all-reduce over a torch.distributed process group and rank 0 prints
the merged summary. The only data reduced is that host-side matrix, once a
run, so the group uses gloo over TCP: it runs on the CPU, also with two
ranks on one card, where NCCL refuses to run.
"""

import zlib
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits for the others to join or to reach the merge
TIMEOUT = timedelta(minutes=30)


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Joins the process group of ``num_processes`` ranks as rank
    ``process_id``, rank 0's store listening at ``coordinator_address``
    (HOST:PORT). A no-op returning False for a single process."""
    if num_processes in (None, 1):
        return False
    num_processes = int(num_processes)
    if not coordinator_address:
        raise ValueError('{} ranks need a coordinator address '
                         '(--coordinator HOST:PORT)'.format(num_processes))
    if process_id is None or not 0 <= int(process_id) < num_processes:
        raise ValueError('the rank (--node-rank) must be in 0..{}, not '
                         '{}'.format(num_processes - 1, process_id))
    dist.init_process_group('gloo',
                            init_method='tcp://' + coordinator_address,
                            world_size=num_processes, rank=int(process_id),
                            timeout=TIMEOUT)
    return True


def initialize_from_config(config):
    """The CLI's bootstrap from the ``num_nodes``, ``node_rank`` and
    ``coordinator`` config keys."""
    n = config.get('num_nodes')
    if not n or int(n) <= 1:
        return False
    return initialize(coordinator_address=config.get('coordinator'),
                      num_processes=int(n),
                      process_id=config.get('node_rank'))


def shutdown():
    """Leaves the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info():
    """(rank, world size); (0, 1) outside a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def owns_entry(readpath, process_index, process_count):
    """Whether rank ``process_index`` of ``process_count`` owns the
    (filename, read_id) entry: a CRC32 over both, the same on every rank
    with no coordination, so entries found one by one (a scan, live mode)
    split as a whole list would."""
    if process_count <= 1:
        return True
    key = (readpath[0] + '\0' + readpath[1]).encode()
    return zlib.crc32(key) % process_count == process_index


def shard_file_list(entries, process_index=None, process_count=None):
    """This rank's entries of a whole list: every process_count-th one,
    from its own index on."""
    rank, size = process_info()
    if process_count is None:
        process_count = size
    if process_index is None:
        process_index = rank
    if process_count == 1:
        return list(entries)
    return [e for i, e in enumerate(entries)
            if i % process_count == process_index]


def allreduce_counts(count_matrix):
    """The sum over every rank of an integer count matrix (numpy int64
    [*dims]), by one all-reduce."""
    if process_info()[1] == 1:
        return np.asarray(count_matrix)
    total = torch.from_numpy(np.array(count_matrix, np.int64))
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total.numpy()


# closed vocabularies of poreplex's labels and statuses (poreplex/io.py:
# 245-260, poreplex/signal_analyzer.py:281-286): the count dicts are laid
# onto these axes, so the merge is one numeric all-reduce
LABEL_VOCAB = ('pass', 'fail', 'artifact')
STATUS_VOCAB = (
    'okay', 'scaler_signal_too_short', 'sequence_too_short',
    'irregular_fast5', 'basecall_table_incomplete', 'adapter_not_detected',
    'not_basecalled', 'scaling_qc_fail', 'disappeared', 'unknown_error',
    'unsplit_read')


def counts_to_matrix(tracker):
    """A FinalSummaryTracker's {(label, barcode, status): count} as an
    int64 [label, barcode, status] matrix (barcode axis in
    tracker.barcode_reporting_order, None last); an unknown label counts
    as 'fail', an unknown status as 'unknown_error'."""
    barcodes = tracker.barcode_reporting_order
    bc_index = {bc: i for i, bc in enumerate(barcodes)}
    unknown = STATUS_VOCAB.index('unknown_error')
    mat = np.zeros((len(LABEL_VOCAB), len(barcodes), len(STATUS_VOCAB)),
                   np.int64)
    for (label, barcode, status), cnt in tracker.counts.items():
        li = LABEL_VOCAB.index(label) if label in LABEL_VOCAB else 1
        bi = bc_index.get(barcode, len(barcodes) - 1)
        si = (STATUS_VOCAB.index(status) if status in STATUS_VOCAB
              else unknown)
        mat[li, bi, si] += cnt
    return mat


def matrix_to_counts(mat, tracker):
    """The inverse of counts_to_matrix: the non-zero cells as a dict."""
    barcodes = tracker.barcode_reporting_order
    counts = {}
    for li, bi, si in zip(*np.nonzero(mat)):
        key = (LABEL_VOCAB[li], barcodes[bi], STATUS_VOCAB[si])
        counts[key] = int(mat[li, bi, si])
    return counts


def merge_final_counts(tracker):
    """The tracker's counts summed over every rank, on every rank."""
    if process_info()[1] == 1:
        return dict(tracker.counts)
    merged = allreduce_counts(counts_to_matrix(tracker))
    return matrix_to_counts(merged, tracker)
