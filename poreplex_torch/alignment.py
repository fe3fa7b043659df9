"""Real-time alignment of the basecalls to a minimap2 index, written as one
BAM file for each (label, barcode) stream (``--align``).

The port's copy of poreplex-tpu's ``alignment.py``. mappy and pysam (both
on PyPI) are optional: they are imported only inside ``AlignmentWriter``
and ``BAMWriter``, and the command line stops with poreplex-tpu's message
when either is missing. The ``.mmi`` header is read here, without them.
"""

from collections import defaultdict
from struct import unpack, calcsize
from threading import Lock

from .utils import ensure_dir_exists

MM_IDX_MAGIC = b'MMI\2'

# SAM FLAG bits (SAM v1; pysam's F* constants)
SAM_FUNMAP = 4
SAM_FREVERSE = 16
SAM_FSECONDARY = 256
SAM_FSUPPLEMENTARY = 2048


def check_minimap2_index(filename):
    with open(filename, 'rb') as idxf:
        if idxf.read(4) != MM_IDX_MAGIC:
            raise Exception('File magic is not found from ' + filename)


def _read_exact(stream, nbytes, filename):
    data = stream.read(nbytes)
    if len(data) != nbytes:
        raise Exception('Unexpected end of file during reading a '
                        'header: ' + filename)
    return data


def get_indexed_sequence_list(indexfile):
    """The SQ lines (name, length) and the indexing options of a minimap2
    ``.mmi``: the 4-byte magic ``MMI\\2``, five little-endian u32 words
    [w, k, bucket bits, n_seq, flags], then for each sequence a u8 name
    length, the name and a little-endian u32 length."""
    with open(indexfile, 'rb') as stream:
        if stream.read(4) != MM_IDX_MAGIC:
            raise Exception('File magic is not found from ' + indexfile)
        window, kmer, _bits, n_seq, _flags = unpack(
            '<IIIII', _read_exact(stream, calcsize('<IIIII'), indexfile))
        sequences = []
        for _ in range(n_seq):
            name_len = _read_exact(stream, 1, indexfile)[0]
            name = _read_exact(stream, name_len, indexfile).decode()
            length, = unpack('<I', _read_exact(stream, 4, indexfile))
            sequences.append({'SN': name, 'LN': length})
    return sequences, 'minimap2 -w {} -k {}'.format(window, kmer)


class BAMWriter:
    """One BAM file; rows are written under a lock."""

    def __init__(self, output, indexed_sequence_list, index_options):
        from pysam import AlignmentFile
        # poreplex-tpu's @PG line, so that both packages write equal files
        header = {'SQ': indexed_sequence_list,
                  'PG': [{'ID': 'minimap2', 'PN': 'minimap2',
                          'CL': index_options,
                          'DS': 'minimap2 invoked by poreplex-tpu'}]}
        ensure_dir_exists(output)
        self.writer = AlignmentFile(output, 'wb', header=header)
        self.lock = Lock()

    def close(self):
        if hasattr(self, 'writer'):
            self.writer.close()
            del self.writer

    def write(self, fields):
        from pysam import AlignedSegment
        line = '\t'.join(map(str, fields))
        segment = AlignedSegment.fromstring(line, self.writer.header)
        with self.lock:
            self.writer.write(segment)


class AlignmentWriter:
    """Maps each basecall with mappy and writes its SAM rows into the BAM
    file of the read's (label, barcode) stream; ``output`` is a path with
    ``{}`` for the stream's name in ``output_layout``."""

    def __init__(self, indexfile, output, output_layout):
        import mappy
        self._mappy = mappy
        self.aligner = mappy.Aligner(indexfile)
        if not self.aligner:
            raise Exception(
                'Could not open minimap2 index {}.'.format(indexfile))
        indexed_sequences, index_options = \
            get_indexed_sequence_list(indexfile)
        self.writers = {
            muxid: BAMWriter(output.format(name), indexed_sequences,
                             index_options)
            for muxid, name in output_layout.items()}

    def close(self):
        for writer in self.writers.values():
            writer.close()
        self.writers.clear()

    def _hit_flag(self, hit, rank):
        """The first hit is the primary alignment (0), or supplementary
        when mappy did not make it primary; every later hit is
        secondary."""
        if rank > 0:
            return SAM_FSECONDARY
        if not hit.is_primary:
            return SAM_FSUPPLEMENTARY
        return 0

    def _hit_row(self, hit, rank, name, seq, qual):
        """One SAM row for one hit: the unaligned query ends soft-clipped;
        a minus-strand hit in reference orientation (reverse complement,
        reversed qualities, the clips swapped); 1-based position; NM."""
        flag = self._hit_flag(hit, rank)
        clips = ['{}S'.format(hit.q_st) if hit.q_st > 0 else '',
                 '{}S'.format(len(seq) - hit.q_en)
                 if hit.q_en < len(seq) else '']
        if hit.strand <= 0:
            flag |= SAM_FREVERSE
            seq = self._mappy.revcomp(seq)
            qual = qual[::-1]
            clips.reverse()
        cigar = clips[0] + hit.cigar_str + clips[1]
        return (name, flag, hit.ctg, hit.r_st + 1, hit.mapq, cigar,
                '*', 0, 0, seq, qual, 'NM:i:{}'.format(hit.NM))

    def sam_records(self, name, seq, qual):
        """Every SAM row of one read, mapped in the DNA alphabet; a read
        with no hit gives the one unmapped row."""
        seq = seq.replace('U', 'T')
        hits = list(self.aligner.map(seq))
        if not hits:
            return [(name, SAM_FUNMAP, '*', 0, 0, '*', '*', 0, 0, seq,
                     qual)]
        return [self._hit_row(hit, rank, name, seq, qual)
                for rank, hit in enumerate(hits)]

    def map_and_write(self, streamid, name, seq, qual, adapter_length):
        """Map one read, its 3' adapter trimmed, into its stream's BAM.
        Returns the contig of its first row ('*' when unmapped), cut at
        the first '|' for the dashboard."""
        if adapter_length > 0:
            seq, qual = seq[:-adapter_length], qual[:-adapter_length]
        rows = self.sam_records(name, seq, qual)
        writer = self.writers[streamid]
        for row in rows:
            writer.write(row)
        contig = rows[0][2]
        if not contig.startswith('|'):
            contig = contig.split('|')[0]
        return contig

    def process(self, results):
        """Map a batch's reports. Returns the dashboard's tallies: the
        mapped contigs of each barcode, and the reads of each barcode that
        had no sequence ('failed') or mapped nowhere ('unmapped')."""
        outcome = {'mapped': defaultdict(list), 'failed': defaultdict(int),
                   'unmapped': defaultdict(int)}
        for result in results:
            barcode = result.get('barcode')
            if result.get('sequence') is None or 'read_id' not in result:
                outcome['failed'][barcode] += 1
                continue
            streamid = result.get('label', 'fail'), barcode
            contig = self.map_and_write(streamid, result['read_id'],
                                        *result['sequence'])
            if contig == '*':
                outcome['unmapped'][barcode] += 1
            else:
                outcome['mapped'][barcode].append(contig)
        return outcome
