"""Pure-Python BGZF (blocked gzip) writer.

The reference writes FASTQ/FASTA outputs through pysam's BGZFile
(poreplex/io.py:23, :51, :218). pysam is not a dependency here, so this is
an independent implementation of the BGZF spec (SAM spec §4.1): a series of
gzip members with a BC extra subfield carrying the compressed block size,
up to 65280 bytes of payload per block, terminated by the canonical 28-byte
EOF block. Output is readable by both `gzip` and htslib/bgzip.
"""

import struct
import zlib

MAX_BLOCK_PAYLOAD = 65280

BGZF_EOF = bytes.fromhex(
    '1f8b08040000000000ff0600424302001b0003000000000000000000')


class BGZFWriter:

    def __init__(self, path, mode='wb'):
        self.fp = open(path, mode)
        self.buffer = bytearray()
        self.closed = False

    def write(self, data):
        if isinstance(data, str):
            data = data.encode('ascii')
        self.buffer.extend(data)
        while len(self.buffer) >= MAX_BLOCK_PAYLOAD:
            chunk = bytes(self.buffer[:MAX_BLOCK_PAYLOAD])
            del self.buffer[:MAX_BLOCK_PAYLOAD]
            self._write_block(chunk)
        return len(data)

    def flush(self):
        if self.buffer:
            chunk = bytes(self.buffer)
            self.buffer.clear()
            self._write_block(chunk)
        self.fp.flush()

    def _write_block(self, payload):
        compressor = zlib.compressobj(6, zlib.DEFLATED, -15)
        compressed = compressor.compress(payload) + compressor.flush()
        # gzip header (10) + XLEN (2) + BC subfield (6) + data + crc/isize (8)
        bsize = 12 + 6 + len(compressed) + 8
        if bsize > 65536:
            # incompressible payload: split and recurse
            half = len(payload) // 2
            self._write_block(payload[:half])
            self._write_block(payload[half:])
            return
        header = struct.pack(
            '<BBBBIBBHBBHH',
            0x1f, 0x8b, 0x08, 0x04,      # magic, deflate, FEXTRA
            0, 0, 0xff,                  # mtime, xfl, os
            6,                           # XLEN
            0x42, 0x43, 2,               # 'BC', subfield length
            bsize - 1)                   # BSIZE - 1
        footer = struct.pack('<II', zlib.crc32(payload) & 0xffffffff,
                             len(payload) & 0xffffffff)
        self.fp.write(header + compressed + footer)

    def close(self):
        if self.closed:
            return
        self.flush()
        self.fp.write(BGZF_EOF)
        self.fp.close()
        self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
