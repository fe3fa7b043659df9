"""Command-line interface: poreplex-tpu's option surface and preflight, run
on the CUDA device unless ``--cpu`` is given.

Console entry point: ``poreplex-torch`` (also ``python -m poreplex_torch``).
The TPU knobs (``--pallas``, ``--prewarm``) have no counterpart.
``--basecall`` needs ONT's albacore and ``--align`` needs mappy and pysam:
without them the run stops with poreplex-tpu's message before any read is
read. ``--dashboard`` is turned off, as in poreplex-tpu, unless
``--align`` is given. ``--mesh-shape`` spreads each batch over that many
cards of this process; ``--num-nodes``, ``--node-rank`` and
``--coordinator`` make this process one rank of several, each analysing
its own share of the reads (parallel/distributed.py).
"""

import argparse
import logging
import os
import shutil
import sys

from . import __version__
from .config import build_config, ingest_process_count
from .utils import errx, errprint

VERSION_STRING = """\
poreplex-torch version {version}
PyTorch/CUDA signal-level preprocessor for nanopore direct RNA sequencing
""".format(version=__version__)


def show_banner():
    print("""
\x1b[1mPoreplex-Torch\x1b[0m version {version}
- Cuts nanopore direct RNA sequencing data into bite-size pieces, on CUDA
""".format(version=__version__))


def init_logging(config):
    """A log file OUTDIR/poreplex.log on the ``poreplex_torch`` logger;
    returns the logger and the file's handler, which the caller removes."""
    logfile = os.path.join(config['outputdir'], 'poreplex.log')
    logger = logging.getLogger('poreplex_torch')
    logger.propagate = False
    handler = logging.FileHandler(logfile, 'w')
    logger.setLevel(logging.INFO)
    handler.setFormatter(logging.Formatter('%(asctime)-15s %(message)s'))
    logger.addHandler(handler)
    return logger, handler


# sink flag -> its subdirectory of the output directory
OUTPUT_SUBDIRS = (
    ('fastq_output', 'fastq'),
    ('fast5_output', 'fast5'),
    ('nanopolish_output', 'nanopolish'),
    ('minimap2_index', 'bam'),
    ('dump_adapter_signals', 'adapter-dumps'),
    ('dump_basecalls', 'events'),
)


def _confirm_clear(outputdir):
    """Ask before wiping a non-empty output directory: y goes on, an empty
    answer or n ends the run, anything else asks again."""
    prompt = ('Output directory {} is not empty. Clear it? '
              '(y/N) '.format(outputdir))
    while True:
        try:
            answer = input(prompt).lower()
        except KeyboardInterrupt:
            raise SystemExit
        if answer.startswith('y'):
            print()
            return
        if not answer or answer.startswith('n'):
            sys.exit(1)


def create_output_directories(config):
    """Prepare the output tree: a non-empty output directory is cleared,
    after asking unless -y, and kept as it is under --resume; the
    subdirectories of the enabled sinks are made; a missing tmpdir is made
    and marked for removal at the end of the run."""
    outputdir = config['outputdir']
    leftovers = [] if config['resume'] else os.listdir(outputdir)
    if leftovers:
        if config['interactive']:
            _confirm_clear(outputdir)
        for entry in leftovers:
            path = os.path.join(outputdir, entry)
            (shutil.rmtree if os.path.isdir(path) else os.unlink)(path)

    for flag, subdir in OUTPUT_SUBDIRS:
        if config[flag]:
            os.makedirs(os.path.join(outputdir, subdir), exist_ok=True)

    if not os.path.isdir(config['tmpdir']):
        os.makedirs(config['tmpdir'])
        config['cleanup_tmpdir'] = True


def show_configuration(config, output):
    """The run's settings, to a file or as lines of a logger."""
    from functools import partial
    if hasattr(output, 'write'):
        _ = partial(print, sep='\t', file=output)
    else:
        _ = lambda *args: output.info(' '.join(map(str, args)))
    bool2yn = lambda b: 'Yes' if b else 'No'

    _("== Analysis settings ======================================")
    _(" * Input:", config['inputdir'],
      '(live, {} sec delay)'.format(config['analysis_start_delay'])
      if config['live'] else '')
    _(" * Output:", config['outputdir'])
    _(" * Device:", config['device'])
    _(" * Device batch size:", config['device_batch_size'])
    _(" * Ingest worker processes:", ingest_process_count(config))
    _(" * Presets:", config['preset_name'])
    _(" * Basecall on-the-fly:\t",
      'Yes (albacore {})'.format(config.get('albacore_version'))
      if config['albacore_onthefly'] else 'No (use previous analyses)')
    _(" * Trim 3' adapter:\t", bool2yn(config['trim_adapter']))
    _(" * Filter concatenated read:", bool2yn(config['filter_unsplit_reads']))
    _(" * Separate by barcode:\t", bool2yn(config['barcoding']))
    _(" * Real-time alignment:\t", bool2yn(config['minimap2_index']))
    _(" * FASTQ in output:\t", bool2yn(config['fastq_output']))
    _(" * FAST5 in output:\t", bool2yn(config['fast5_output']))
    _(" * Basecall table in output:", bool2yn(config['dump_basecalls']))
    if config['dump_adapter_signals']:
        _(" * Dump adapter signals for training:", "Yes")
    _("===========================================================")
    _("")


def test_optional_features(config):
    """Stop when a package that an asked-for stage needs is missing;
    with on-the-fly basecalling, write albacore's configuration into the
    output directory."""
    if config['albacore_onthefly']:
        from .basecall_albacore import albacore_available, prepare_albacore
        if not albacore_available():
            errx('ERROR: On-the-fly basecalling (--basecall) requires the '
                 'ONT albacore package.')
        config['albacore_configuration'] = os.path.join(
            config['outputdir'], 'albacore-configuration.cfg')
        config['albacore_version'] = prepare_albacore(
            config['albacore_configuration'], config['flowcell'],
            config['kit'])

    if config['minimap2_index']:
        try:
            import mappy  # noqa: F401
            import pysam  # noqa: F401
        except ImportError:
            errx('ERROR: Real-time alignment (--align) requires mappy and '
                 'pysam.')


def test_inputs_and_outputs(config):
    if not os.path.isdir(config['inputdir']):
        errx('ERROR: Cannot open the input directory {}.'.format(
            config['inputdir']))
    if not os.path.isdir(config['outputdir']):
        try:
            os.makedirs(config['outputdir'])
        except OSError:
            errx('ERROR: Failed to create the output directory {}.'.format(
                config['outputdir']))
    if config['minimap2_index']:
        from .alignment import check_minimap2_index
        try:
            check_minimap2_index(config['minimap2_index'])
        except Exception:
            errx('ERROR: Could not load a minimap2 index from {}.'.format(
                config['minimap2_index']))


def fix_options(config):
    if config['dashboard'] and not config['minimap2_index']:
        errprint('WARNING: Dashboard is turned off because it is not '
                 'informative without sequence alignments.')
        config['dashboard'] = False
        errprint('')


def config_options(args):
    """The run options of the command line, as build_config takes them."""
    return dict(
        quiet=args.quiet,
        interactive=not args.yes,
        live=args.live,
        analysis_start_delay=args.live_delay if args.live else 0,
        dashboard=args.dashboard,
        albacore_onthefly=args.basecall,
        contig_aliases=args.contig_aliases,
        tmpdir=args.tmpdir,
        barcoding=args.barcoding,
        barcoding_quality_filter=args.barcoding_quality_filter,
        measure_polya=args.polya,
        filter_unsplit_reads=args.filter_chimera,
        batch_chunk_size=args.batch_size,
        dump_adapter_signals=args.dump_adapter_signals,
        dump_basecalls=args.dump_basecalled_events,
        fastq_output=args.align is None or args.fastq,
        fast5_output=args.fast5 or args.nanopolish,
        fast5_batch_size=args.fast5_batch_size,
        nanopolish_output=args.nanopolish,
        trim_adapter=args.trim_adapter,
        minimum_sequence_length=args.minimum_length,
        minimap2_index=args.align if args.align else None,
        device_batch_size=args.device_batch_size,
        wire_precision=args.wire_precision,
        resume=args.resume,
        parallel=max(1, args.parallel),
        nobasecall_stop_trigger=1000,
        device='cpu' if args.cpu else 'cuda',
        mesh_shape=args.mesh_shape,
        num_nodes=args.num_nodes,
        node_rank=args.node_rank,
        coordinator=args.coordinator,
    )


def main(args, source=None):
    """Run a session from parsed arguments. ``source`` replaces the input
    directory's FAST5 files as the session's reads (pipeline/source.py).
    Returns the final summary's printer, or None when the run did not
    process every read it found."""
    if not args.quiet:
        show_banner()

    options = config_options(args)
    fix_options(options)
    try:
        config = build_config(args.input, args.output, args.config,
                              **options)
    except (RuntimeError, NotImplementedError, OSError) as exc:
        errx('ERROR: {}'.format(exc))

    test_inputs_and_outputs(config)
    create_output_directories(config)

    from .parallel import distributed
    logger, handler = init_logging(config)
    try:
        test_optional_features(config)
        # every rank joins the process group before its session starts
        try:
            distributed.initialize_from_config(config)
        except ValueError as exc:
            errx('ERROR: {}'.format(exc))
        logger.info('Starting poreplex-torch version {}'.format(__version__))
        logger.info('Command line: ' + ' '.join(sys.argv))

        show_configuration(config, output=logger)
        if not config['quiet']:
            show_configuration(config, output=sys.stdout)

        from .pipeline.session import ProcessingSession
        procresult = ProcessingSession.run(config, logger, source)

        if procresult is not None:
            if not config['quiet']:
                procresult(sys.stdout)
            procresult(logger)

        logger.info('Finished.')
    finally:
        distributed.shutdown()
        logger.removeHandler(handler)
        handler.close()

    if config['cleanup_tmpdir']:
        try:
            shutil.rmtree(config['tmpdir'])
        except OSError:
            pass
    return procresult


def build_parser():
    parser = argparse.ArgumentParser(
        prog='poreplex-torch', add_help=False,
        description='Cuts nanopore direct RNA sequencing data into bite-size '
                    'pieces for RNA Biology, on a CUDA device')

    group = parser.add_argument_group('Data Settings')
    group.add_argument('-i', '--input', required=True, metavar='DIR',
                       help='path to the directory with the input FAST5 '
                            'files (Required)')
    group.add_argument('-o', '--output', required=True, metavar='DIR',
                       help='output directory path (Required)')
    group.add_argument('-c', '--config', default='', metavar='NAME',
                       help='path to signal processing configuration')

    group = parser.add_argument_group('Basic Processing Options')
    group.add_argument('--trim-adapter', default=False, action='store_true',
                       help="trim 3' adapter sequences from FASTQ outputs")
    group.add_argument('--minimum-length', default=10, type=int,
                       metavar='LEN',
                       help='discard reads shorter than LEN (default: 10)')
    group.add_argument('--filter-chimera', default=False, action='store_true',
                       help='remove unsplit reads fused of two or more RNAs '
                            'in output')

    group = parser.add_argument_group('Optional Analyses')
    group.add_argument('--barcoding', default=False, action='store_true',
                       help='sort barcoded reads into separate outputs')
    group.add_argument('--barcoding-quality-filter', default=18, type=int,
                       metavar='SCORE',
                       help='ignore barcode patterns having quality scores '
                            'lower than SCORE in phred-scale (default: 18)')
    group.add_argument('--polya', default=False, action='store_true',
                       help='output poly(A) tail length measurements')
    group.add_argument('--basecall', default=False, action='store_true',
                       help='call the ONT albacore for basecalling '
                            'on-the-fly')
    group.add_argument('--align', default=None, type=str,
                       metavar='INDEXFILE',
                       help='align basecalled reads using minimap2 and '
                            'create BAM files')

    group = parser.add_argument_group('Live Mode')
    group.add_argument('--live', default=False, action='store_true',
                       help='monitor new files in the input directory')
    group.add_argument('--live-delay', default=60, type=int,
                       metavar='SECONDS',
                       help='time to delay the start of analysis in live '
                            'mode (default: 60)')

    group = parser.add_argument_group('Output Options')
    group.add_argument('--fastq', default=False, action='store_true',
                       help='write to FASTQ files even when BAM files are '
                            'produced')
    group.add_argument('--fast5', default=False, action='store_true',
                       help='link or copy FAST5 files to separate output '
                            'directories')
    group.add_argument('--fast5-batch-size', default=4000, type=int,
                       help='number of reads in a FAST5 for output')
    group.add_argument('--nanopolish', default=False, action='store_true',
                       help='create a nanopolish readdb to enable access '
                            'from nanopolish')
    group.add_argument('--dump-adapter-signals', default=False,
                       action='store_true',
                       help='dump adapter signal dumps for training')
    group.add_argument('--dump-basecalled-events', default=False,
                       action='store_true',
                       help='dump basecalled events to the output')

    group = parser.add_argument_group('User Interface')
    group.add_argument('--dashboard', default=False, action='store_true',
                       help='show the full screen dashboard')
    group.add_argument('--contig-aliases', default=None, metavar='FILE',
                       type=str,
                       help='path to a tab-separated text file for aliases '
                            'to show as a contig names in the dashboard')
    group.add_argument('-q', '--quiet', default=False, action='store_true',
                       help='suppress non-error messages')
    group.add_argument('-y', '--yes', default=False, action='store_true',
                       help='suppress all questions')

    group = parser.add_argument_group('Pipeline Options')
    group.add_argument('-p', '--parallel', default=1, type=int,
                       metavar='COUNT',
                       help='number of host ingest worker processes: with '
                            '2 or more, each batch\'s reads are read by '
                            'that many processes (FAST5 through the native '
                            'HDF5 reader, else h5py), with 1 in the '
                            'analyzer\'s process; either way the next batch '
                            'is read while the current one computes '
                            '(default: 1)')
    group.add_argument('--device-batch-size', default=256, type=int,
                       metavar='SIZE',
                       help='reads per stage-1 launch on the device '
                            '(default: 256)')
    group.add_argument('--wire-precision', default='exact',
                       choices=('exact', 'fast'),
                       help='host->device signal transport: "exact" u16 '
                            'fixed point (lossless in practice) or "fast" '
                            'u8 per-read affine (half the upload bytes, '
                            '~0.5 pA quantization; default: exact)')
    group.add_argument('--tmpdir', default='', type=str, metavar='DIR',
                       help='temporary directory for intermediate data')
    group.add_argument('--batch-size', default=256, type=int, metavar='SIZE',
                       help='number of reads in a single batch '
                            '(default: 256)')
    group.add_argument('--cpu', default=False, action='store_true',
                       help='run on the host CPU (the plain PyTorch '
                            'versions of the kernels) instead of the CUDA '
                            'device')
    group.add_argument('--mesh-shape', default=None, type=int, metavar='N',
                       help='number of local CUDA cards each batch is '
                            'spread over (default: every visible card; '
                            'with --cpu, N entries of the CPU)')

    group = parser.add_argument_group('Distributed (multi-host)')
    group.add_argument('--num-nodes', default=None, type=int, metavar='N',
                       help='total number of ranks (processes), each '
                            'analysing its own share of the reads')
    group.add_argument('--node-rank', default=None, type=int, metavar='I',
                       help='rank of this process, 0 to N-1; rank 0 prints '
                            'the merged counts')
    group.add_argument('--coordinator', default=None, metavar='HOST:PORT',
                       help='address where rank 0 listens for the others '
                            '(torch.distributed, gloo over TCP)')
    group.add_argument('--resume', default=False, action='store_true',
                       help='keep the output directory and skip reads '
                            'recorded in its processed-read manifest (the '
                            'summary and FASTQ files are written anew, so '
                            'they hold only the reads of the resumed run)')
    group.add_argument('--version', action='version',
                       version=VERSION_STRING)
    group.add_argument('-h', '--help', action='help',
                       help='show this help message and exit')
    return parser


def parse_args(argv):
    return build_parser().parse_args(argv)


def __main__():
    main(parse_args(sys.argv[1:]))


if __name__ == '__main__':
    __main__()
