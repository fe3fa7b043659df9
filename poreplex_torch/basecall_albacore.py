"""On-the-fly basecalling with ONT's albacore (``--basecall``).

The port's copy of poreplex-tpu's ``basecall_albacore.py``: albacore's
PipelineCore, in single-process mode, basecalls each read in PHASE C, and
its output becomes the event table poly(A) and trimming read. albacore is
proprietary, runs on the host CPU and is not on PyPI; it is imported only
here, inside the functions that use it, and the command line stops with
poreplex-tpu's message when it is missing.
"""

import configparser
import sys

import numpy as np


def albacore_available():
    try:
        import albacore  # noqa: F401
        return True
    except ImportError:
        return False


def prepare_albacore(configpath, flowcell, kit):
    """Check albacore's version (2.3 or later), pick its configuration for
    the flowcell and kit, and write that configuration to ``configpath``
    with ``min_qscore = 0``. Returns albacore's version."""
    from albacore import MIN_QSCORE  # noqa: F401
    from albacore.config_utils import get_barcoding_options  # noqa: F401
    from albacore.path_utils import get_default_path
    from albacore.config_selector import choose_config
    from albacore import __version__ as albacore_version

    if tuple(int(p) for p in albacore_version.split('.')[:2]) < (2, 3):
        raise RuntimeError('albacore >= 2.3.0 is required (found {})'
                           .format(albacore_version))

    data_path = get_default_path('', sys.argv)
    config, _ = choose_config(data_path, flowcell, kit)

    parser = configparser.ConfigParser(interpolation=None)
    parser.read(config)
    parser['basecaller']['min_qscore'] = '0'
    with open(configpath, 'w') as f:
        parser.write(f)
    return albacore_version


class AlbacoreBroker:

    def __init__(self, configpath, kmersize):
        from albacore.pipeline_core import PipelineCore
        self.core = PipelineCore(configpath, 0)  # single-process mode
        self.kmersize = kmersize

    def basecall(self, rawdata, f5reader, read_name):
        """Basecall one read: ``rawdata`` is its signal in pA (float32),
        ``f5reader`` anything with the read's ``channel_number``,
        ``start_time`` (samples), ``duration`` and ``sampling_rate``.
        Returns the sequence reversed into RNA order with T -> U, its
        quality string, the event table and the counts, or None when
        albacore returns nothing."""
        self.core.pass_data(read_name, rawdata, {
            'channel_id': f5reader.channel_number,
            'start_time': f5reader.start_time,
            'duration': f5reader.duration,
            'sampling_rate': f5reader.sampling_rate,
        })
        self.core.finish_all_jobs()
        results = self.core.get_results()
        if not results:
            return None
        res = results[0]

        events = self.adopt_basecalled_table(res['events'])
        sequence = res['sequence'][::-1].replace('T', 'U')
        qstring = res['qstring'][::-1]
        return {
            'events': events,
            'sequence': sequence,
            'qstring': qstring,
            'sequence_length': len(sequence),
            'mean_qscore': res['mean_qscore'],
            'called_events': len(events),
        }

    def adopt_basecalled_table(self, events):
        from .fast5 import EventTable
        return EventTable.from_structured(np.asarray(events))
