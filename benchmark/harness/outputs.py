"""The session's written outputs and their comparison with the
reference's."""

import gzip
import os

# statuses of reads that the session could not open or analyse; every
# other status is the read's result, a read stopped by the scaling QC
# or with no adapter among them
FAILED_STATUSES = ('unknown_error', 'irregular_fast5', 'disappeared')


class ResultRecorder:
    """The status of every result that the session hands its final
    summary, by read id, recorded for the window by wrapping the
    tracker's ``feed_results``. It is kept apart from the summary rows:
    a read stopped early, as by the scaling QC, has a result and a
    status but no label, so upstream's summary writer leaves it out."""

    def __init__(self):
        self.status = {}         # read id: status
        self._tracker = self._feed = None

    def __enter__(self):
        from poreplex_torch.io.writers import FinalSummaryTracker
        self._tracker = FinalSummaryTracker
        status, feed = self.status, FinalSummaryTracker.feed_results
        self._feed = feed

        def recording_feed(tracker, results):
            for entry in results:
                status[entry['read_id']] = entry['status']
            return feed(tracker, results)
        FinalSummaryTracker.feed_results = recording_feed
        return self

    def __exit__(self, *exc):
        self._tracker.feed_results = self._feed

    def completed(self, served):
        """The served read ids with a result that is no failure."""
        return [rid for rid in served if rid in self.status and
                self.status[rid] not in FAILED_STATUSES]


def summary_rows(outdir):
    """{read id: {field: value}} of OUTDIR/sequencing_summary.txt."""
    with open(os.path.join(outdir, 'sequencing_summary.txt')) as f:
        lines = f.read().splitlines()
    header = lines[0].split('\t')
    rows = {}
    for line in lines[1:]:
        row = dict(zip(header, line.split('\t')))
        rows[row['read_id']] = row
    return rows


def fastq_records(outdir, wanted):
    """{read id: (stream, sequence, quality)} of the FASTQ records of
    the read ids in ``wanted``; the stream is the file's path under
    OUTDIR/fastq."""
    records = {}
    top = os.path.join(outdir, 'fastq')
    for root, _, files in os.walk(top):
        for fn in files:
            path = os.path.join(root, fn)
            stream = os.path.relpath(path, top)
            with gzip.open(path, 'rt') as f:
                lines = f.read().splitlines()
            for i in range(0, len(lines) - 3, 4):
                read_id = lines[i][1:]
                if read_id in wanted:
                    records[read_id] = (stream, lines[i + 1], lines[i + 3])
    return records


def compare(judged, rows, fastq, expected):
    """Rows and FASTQ records of the judged read ids ({read id: pool
    index}) against the reference's ({pool index: (row fields, FASTQ)}).
    Returns the numbers compared, and the differing fields by name:

    - judged: judged reads;
    - missing: judged reads with no row where the reference has one, or
      a row where it has none;
    - differ: judged reads whose row or FASTQ record differs, a dwell
      time counted only where one side has a tail and the other none;
    - dwell_gap: the widest gap between two tails' dwell times, in
      seconds;
    - differing: the pool indices of the reads missing or differing."""
    missing = differ = 0
    dwell_gap = 0.0
    fields, gaps, differing = {}, [], set()
    for read_id, index in judged.items():
        want_row, want_fastq = expected[index]
        got = rows.get(read_id)
        if (got is None) != (want_row is None):
            missing += 1
            differing.add(index)
            continue
        if got is None:
            continue
        bad = [k for k in want_row if k != 'polya_dwell' and
               got.get(k) != want_row[k]]
        if fastq.get(read_id) != want_fastq:
            bad.append('fastq')
        if 'polya_dwell' in want_row:
            a, b = got.get('polya_dwell', ''), want_row['polya_dwell']
            if (a == '') != (b == ''):
                bad.append('polya_dwell')
                gaps.append((index, a, b))
            elif a != b:
                dwell_gap = max(dwell_gap, abs(float(a) - float(b)))
                gaps.append((index, a, b))
        if bad:
            differ += 1
            differing.add(index)
            for k in bad:
                fields[k] = fields.get(k, 0) + 1
    numbers = dict(judged=len(judged), missing=missing, differ=differ,
                   dwell_gap=dwell_gap, differing=sorted(differing))
    return numbers, fields, sorted(set(gaps))


# the limit of the share of judged reads whose row or FASTQ record
# differs (PERF.md section 2 gives the readings it was set from); the
# widest dwell gap's limit grows with the tails, and each traffic mix
# states its own (``dwell_gap_limit_s``)
ROWS_DIFFER_LIMIT = 0.05
