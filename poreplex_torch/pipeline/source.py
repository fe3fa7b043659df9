"""Where a session's reads come from.

A source lists its files, lists the (filename, read_id) entries of a file,
tells whether a file is still there, opens readers for the reads of one
batch, and gives the files' modification times to the live watcher.

- ``DirectorySource``: the FAST5 files under an input directory, read with
  h5py (``fast5.Fast5Reader``); the reads of one multi-read file in a
  batch share one open handle.
- ``MemorySource``: ``simulate.SimulatedRead`` objects held in memory, all
  under the one file name ``simulated.fast5`` and opened as
  ``simulate.MemoryRead``. It lets a session run where no FAST5 can be
  read; the FAST5 and dump sinks, which need h5py and input files, are
  refused with it.
"""

import os

from .. import fast5, simulate

FAST5_SUFFIX = '.fast5'


def scan_dir(topdir, dirname='', suffix=FAST5_SUFFIX):
    """Paths, relative to topdir, of every FAST5 file under it: a
    directory's files (in listing order) before its subdirectories."""
    files, dirs = [], []
    for entryname in os.listdir(os.path.join(topdir, dirname)):
        if entryname.startswith('.'):
            continue
        relpath = os.path.join(dirname, entryname)
        if os.path.isdir(os.path.join(topdir, relpath)):
            dirs.append(relpath)
        elif entryname.lower().endswith(suffix):
            files.append(relpath)
    yield from files
    for relpath in dirs:
        yield from scan_dir(topdir, relpath, suffix)


class DirectorySource:

    holds_files = True

    def __init__(self, topdir):
        self.topdir = topdir

    def list_files(self):
        return list(scan_dir(self.topdir))

    def read_ids(self, relpath):
        return fast5.get_read_ids(relpath, self.topdir)

    def exists(self, filename):
        return os.path.exists(os.path.join(self.topdir, filename))

    def opener(self):
        """open(filename, read_id) -> reader, for the reads of one batch;
        close each reader when done."""
        pool = fast5.Fast5FilePool()
        return lambda filename, read_id: fast5.Fast5Reader(
            os.path.join(self.topdir, filename), read_id, pool=pool)

    def snapshot(self, suffix=FAST5_SUFFIX):
        """{relative path: mtime} of every FAST5 file under the input."""
        snapshot = {}
        for root, dirs, files in os.walk(self.topdir):
            dirs[:] = [d for d in dirs if not d.startswith('.')]
            for fn in files:
                if fn[:1] != '.' and fn.lower().endswith(suffix):
                    full = os.path.join(root, fn)
                    try:
                        snapshot[os.path.relpath(full, self.topdir)] = \
                            os.stat(full).st_mtime
                    except OSError:
                        pass
        return snapshot


class MemorySource:

    FILENAME = 'simulated.fast5'
    holds_files = False

    def __init__(self, reads):
        self.reads = {read.read_id: read for read in reads}

    def list_files(self):
        return [self.FILENAME]

    def read_ids(self, relpath):
        return [(self.FILENAME, read_id) for read_id in self.reads]

    def exists(self, filename):
        return filename == self.FILENAME

    def opener(self):
        return lambda filename, read_id: simulate.MemoryRead(
            self.reads[read_id])

    def snapshot(self):
        return {self.FILENAME: 0.0}
