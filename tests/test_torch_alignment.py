"""poreplex_torch.alignment against poreplex_tpu.alignment without mappy or
pysam: every case of tests/test_alignment.py (SAM rows, flags, clips and
orientation, adapter trimming, the dashboard's tallies, the .mmi header)
runs through both packages' AlignmentWriter with the same fake hits, and
the rows, tallies and headers must be equal. Also the stand-ins of mappy
and pysam that the whole-session tests install (tests/
test_torch_host_stages.py): ``install_aligner`` puts them in sys.modules
through a MonkeyPatch, which undoes it after the test."""

import struct
import sys
import types

import pytest

from poreplex_tpu import alignment as jax_alignment
from poreplex_torch import alignment

COMPLEMENT = str.maketrans('ACGT', 'TGCA')


def revcomp(seq):
    return seq.translate(COMPLEMENT)[::-1]


# ------------------------------------------------------------ stand-ins

class Hit:
    """The attributes of a mappy.Alignment that the writers read."""

    def __init__(self, ctg='chr1', r_st=99, q_st=0, q_en=None, strand=1,
                 mapq=60, cigar_str='10M', NM=1, is_primary=True, qlen=10):
        self.ctg = ctg
        self.r_st = r_st
        self.q_st = q_st
        self.q_en = qlen if q_en is None else q_en
        self.strand = strand
        self.mapq = mapq
        self.cigar_str = cigar_str
        self.NM = NM
        self.is_primary = is_primary


def make_mappy(contigs):
    """A stand-in mappy whose Aligner maps a query to every contig of
    ``contigs`` ({name: DNA sequence}, in order) that holds it or its
    reverse complement, as a full-length match: the first hit primary,
    the others secondary. ``Aligner.queries`` lists what was mapped."""
    queries = []

    class Aligner:
        def __init__(self, indexfile):
            self.indexfile = indexfile

        def map(self, seq):
            queries.append(seq)
            for name, contig in contigs.items():
                for strand, query in ((1, seq), (-1, revcomp(seq))):
                    at = contig.find(query)
                    if at >= 0 and seq:
                        yield Hit(ctg=name, r_st=at, q_st=0, q_en=len(seq),
                                  strand=strand, mapq=60, NM=0,
                                  cigar_str='{}M'.format(len(seq)),
                                  is_primary=True, qlen=len(seq))

    Aligner.queries = queries
    return types.SimpleNamespace(Aligner=Aligner, revcomp=revcomp)


class AlignedSegment:
    def __init__(self, line):
        self.line = line

    @classmethod
    def fromstring(cls, line, header):
        return cls(line)


class AlignmentFile:
    """Writes SAM text: the header's @SQ and @PG lines, then a row a
    segment."""

    def __init__(self, path, mode, header):
        assert mode == 'wb'
        self.header = header
        self.file = open(path, 'w')
        for sq in header['SQ']:
            self.file.write('@SQ\tSN:{SN}\tLN:{LN}\n'.format(**sq))
        for pg in header['PG']:
            self.file.write('@PG\t' + '\t'.join(
                '{}:{}'.format(k, v) for k, v in pg.items()) + '\n')

    def write(self, segment):
        self.file.write(segment.line + '\n')

    def close(self):
        self.file.close()


PYSAM = types.SimpleNamespace(AlignmentFile=AlignmentFile,
                              AlignedSegment=AlignedSegment)


def install_aligner(monkeypatch, contigs):
    """Stand-in mappy (over ``contigs``) and pysam in sys.modules; returns
    the mappy stand-in."""
    mappy = make_mappy(contigs)
    monkeypatch.setitem(sys.modules, 'mappy', mappy)
    monkeypatch.setitem(sys.modules, 'pysam', PYSAM)
    return mappy


def write_mmi(path, contigs, window=10, kmer=15):
    """A minimap2 .mmi header naming ``contigs`` ({name: length or
    sequence})."""
    with open(path, 'wb') as f:
        f.write(b'MMI\2')
        f.write(struct.pack('<IIIII', window, kmer, 14, len(contigs), 0))
        for name, contig in contigs.items():
            length = contig if isinstance(contig, int) else len(contig)
            f.write(bytes([len(name)]) + name.encode() +
                    struct.pack('<I', length))
    return str(path)


# ------------------------------------------------------ the cases

class RecordingBAM:
    def __init__(self):
        self.rows = []

    def write(self, fields):
        self.rows.append(fields)


class FakeAligner:
    def __init__(self, hits):
        self.hits = hits
        self.queries = []

    def map(self, seq):
        self.queries.append(seq)
        return iter(self.hits)


def make_writer(module, hits, streams=(('pass', None),)):
    """``module``'s AlignmentWriter over a fake aligner and recording
    BAMs, as tests/test_alignment.py builds one."""
    w = object.__new__(module.AlignmentWriter)
    w._mappy = types.SimpleNamespace(revcomp=revcomp)
    w.aligner = FakeAligner(list(hits))
    w.writers = {sid: RecordingBAM() for sid in streams}
    return w


def case_unmapped(module, tmp_path):
    w = make_writer(module, [])
    return w.sam_records('r1', 'ACGUACGUAC', 'IIIIIIIIII'), w.aligner.queries


def case_forward_primary_with_clips(module, tmp_path):
    w = make_writer(module, [Hit(q_st=2, q_en=7, qlen=10, cigar_str='5M')])
    return w.sam_records('r1', 'ACGTACGTAC', '0123456789')


def case_reverse_secondary(module, tmp_path):
    hits = [Hit(), Hit(ctg='chr2', q_st=2, q_en=7, qlen=10, strand=-1,
                       cigar_str='5M')]
    return make_writer(module, hits).sam_records('r1', 'ACGTACGTAC',
                                                 '0123456789')


def case_supplementary(module, tmp_path):
    return make_writer(module, [Hit(is_primary=False)]).sam_records(
        'r1', 'ACGTACGTAC', 'IIIIIIIIII')


def case_adapter_trim(module, tmp_path):
    hit = Hit(ctg='ENST0001|GENE', qlen=8, q_en=8, cigar_str='8M')
    w = make_writer(module, [hit], streams=(('pass', 0),))
    contig = w.map_and_write(('pass', 0), 'r1', 'ACGTACGTAC', '0123456789',
                             2)
    return contig, w.writers[('pass', 0)].rows, w.aligner.queries


def case_leading_bar_contig(module, tmp_path):
    hit = Hit(ctg='|odd', qlen=4, q_en=4, cigar_str='4M')
    w = make_writer(module, [hit])
    return w.map_and_write(('pass', None), 'r1', 'ACGU', 'IIII', 0)


def case_tallies(module, tmp_path):
    w = make_writer(module, [], streams=(('pass', 0), ('pass', 1),
                                         ('fail', None)))
    out = w.process([
        {'read_id': 'a', 'label': 'pass', 'barcode': 0,
         'sequence': ('ACGT', 'IIII', 0)},
        {'label': 'fail', 'barcode': None, 'status': 'not_basecalled'},
        {'read_id': 'c', 'label': 'fail', 'barcode': None,
         'sequence': None},
    ])
    w2 = make_writer(module, [Hit(qlen=4, q_en=4, cigar_str='4M')],
                     streams=(('pass', 1),))
    out2 = w2.process([{'read_id': 'b', 'label': 'pass', 'barcode': 1,
                        'sequence': ('ACGU', 'IIII', 0)}])
    return ([{k: dict(v) for k, v in o.items()} for o in (out, out2)],
            w.writers[('pass', 0)].rows, w2.writers[('pass', 1)].rows)


def case_mmi_header(module, tmp_path):
    path = write_mmi(tmp_path / 'x.mmi', {'chr1': 1000, 'tig00042': 77,
                                          'contig|x': 250})
    module.check_minimap2_index(path)
    return module.get_indexed_sequence_list(path)


CASES = {name[len('case_'):]: fn for name, fn in sorted(globals().items())
         if name.startswith('case_')}


@pytest.mark.parametrize('case', sorted(CASES))
def test_same_rows_and_tallies(case, tmp_path):
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'torch').mkdir()
    ref = CASES[case](jax_alignment, tmp_path / 'jax')
    got = CASES[case](alignment, tmp_path / 'torch')
    assert got == ref
    assert got


@pytest.mark.parametrize('magic', [b'NOPE', b'MMI', b''])
def test_bad_magic_refused_by_both(magic, tmp_path):
    bad = tmp_path / 'bad.mmi'
    bad.write_bytes(magic)
    errors = []
    for module in (jax_alignment, alignment):
        with pytest.raises(Exception) as exc:
            module.check_minimap2_index(str(bad))
        errors.append(str(exc.value))
        with pytest.raises(Exception, match='magic'):
            module.get_indexed_sequence_list(str(bad))
    assert errors[0] == errors[1]


def test_truncated_header_refused_by_both(tmp_path):
    path = write_mmi(tmp_path / 'x.mmi', {'chr1': 1000})
    data = open(path, 'rb').read()
    cut = tmp_path / 'cut.mmi'
    cut.write_bytes(data[:-2])
    errors = []
    for module in (jax_alignment, alignment):
        with pytest.raises(Exception, match='Unexpected end') as exc:
            module.get_indexed_sequence_list(str(cut))
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_writers_through_the_stand_ins(tmp_path, monkeypatch):
    """Both packages' AlignmentWriter built on the stand-in mappy and
    pysam write the same SAM text to the same files and return the same
    tallies."""
    contigs = {'chrA|gene': 'GGGG' + 'ACGTTGCA' + 'CCCC',
               'chrB': 'TTTT' + revcomp('CAAGCATG') + 'AAAA'}
    layout = {('pass', 0): 'pass/BC1', ('pass', None): 'pass/undetermined',
              ('fail', None): 'fail/undetermined'}
    results = [
        {'read_id': 'fwd', 'label': 'pass', 'barcode': 0,
         'sequence': ('ACGUUGCAGG', '0123456789', 2)},
        {'read_id': 'rev', 'label': 'pass', 'barcode': None,
         'sequence': ('CAAGCAUG', 'abcdefgh', 0)},
        {'read_id': 'none', 'label': 'fail', 'barcode': None,
         'sequence': ('GGAAGGAA', 'IIIIIIII', 0)},
        {'read_id': 'short', 'label': 'fail', 'barcode': None,
         'status': 'adapter_not_detected'},
    ]
    texts, tallies = [], []
    for module in (jax_alignment, alignment):
        mappy = install_aligner(monkeypatch, contigs)
        index = write_mmi(tmp_path / 'ref.mmi', contigs)
        out = tmp_path / module.__name__
        writer = module.AlignmentWriter(
            index, str(out / 'bam' / '{}.bam'), layout)
        tallies.append({k: dict(v) for k, v in
                        writer.process(results).items()})
        writer.close()
        assert mappy.Aligner.queries == ['ACGTTGCA', 'CAAGCATG', 'GGAAGGAA']
        texts.append({name: (out / 'bam' / (name + '.bam')).read_text()
                      for name in layout.values()})
    assert texts[0] == texts[1]
    assert tallies[0] == tallies[1] == {
        'mapped': {0: ['chrA'], None: ['chrB']},
        'failed': {None: 1}, 'unmapped': {None: 1}}
    rows = texts[1]['pass/undetermined'].splitlines()
    assert rows[-1].split('\t')[:6] == ['rev', '16', 'chrB', '5', '60',
                                        '8M']
