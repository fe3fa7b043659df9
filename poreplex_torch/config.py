"""Configuration: a JSON preset overlaid with run options.

The preset ``presets/rna-r941.json`` is the JSON form of poreplex-tpu's
``rna-r941.yaml`` (the same numeric knobs and HMM specifications); JSON
because the port's runtime has no YAML parser.
"""

import copy
import json
import os

from . import (OUTPUT_NAME_PASSED, OUTPUT_NAME_FAILED, OUTPUT_NAME_ARTIFACT,
               OUTPUT_NAME_BARCODES, OUTPUT_NAME_UNDETERMINED,
               OUTPUT_NAME_BARCODING_OFF)

PRESETS_DIR = os.path.join(os.path.dirname(__file__), 'presets')


def resolve_preset_path(name_or_path):
    """A file path, a bundled preset name, or the default preset."""
    if not name_or_path:
        return os.path.join(PRESETS_DIR, 'rna-r941.json')
    if os.path.isfile(name_or_path):
        return name_or_path
    candidate = os.path.join(PRESETS_DIR, name_or_path + '.json')
    if os.path.isfile(candidate):
        return candidate
    raise FileNotFoundError(
        'Cannot find a configuration in {}.'.format(name_or_path))


def load_preset(name_or_path=''):
    """Load a preset into a plain dict, resolving asset paths against the
    bundled presets directory."""
    with open(resolve_preset_path(name_or_path)) as f:
        config = json.load(f)

    kmer_models_dir = os.path.join(PRESETS_DIR, 'kmer_models')
    if 'kmer_model' in config and not os.path.isabs(config['kmer_model']):
        config['kmer_model'] = os.path.join(kmer_models_dir,
                                            config['kmer_model'])
    for section, key in (('signal_processing', 'scaler_model'),
                         ('demultiplexing', 'demux_model')):
        if section in config and key in config[section]:
            val = config[section][key]
            if not os.path.isabs(val):
                config[section][key] = os.path.join(PRESETS_DIR, val)
    return config


def setup_output_name_mapping(config):
    """(label, barcode) -> relative output path. Without barcoding every
    label writes one stream keyed ``(label, None)``; with barcoding each
    label fans out into one directory per barcode plus 'undetermined'.
    The 'artifact' label exists when the unsplit-read filter can give
    it."""
    label_names = {'fail': OUTPUT_NAME_FAILED, 'pass': OUTPUT_NAME_PASSED}
    if config['filter_unsplit_reads']:
        label_names['artifact'] = OUTPUT_NAME_ARTIFACT
    if not config['barcoding']:
        barcode_names = {None: OUTPUT_NAME_BARCODING_OFF}
        layout = {(label, None): dirname
                  for label, dirname in label_names.items()}
        return label_names, barcode_names, layout

    barcode_names = {None: OUTPUT_NAME_UNDETERMINED}
    barcode_names.update(
        (bc, OUTPUT_NAME_BARCODES.format(n=bc + 1))
        for bc in range(config['demultiplexing']['number_of_barcodes']))
    layout = {}
    for label, dirname in label_names.items():
        for bc, bcname in barcode_names.items():
            layout[(label, bc)] = os.path.join(dirname, bcname)
    return label_names, barcode_names, layout


DEFAULT_OPTIONS = dict(
    quiet=True,
    interactive=False,       # ask before clearing a non-empty output dir
    parallel=1,              # -p: the ingest workers of 'auto'
    ingest_processes='auto',  # PHASE A worker processes ('auto': below)
    live=False,
    analysis_start_delay=0,  # seconds before a live batch is analysed
    contig_aliases=None,
    barcoding=False,
    barcoding_quality_filter=18,
    batch_chunk_size=256,    # reads per analyzer batch
    fastq_output=True,
    fast5_output=False,
    fast5_batch_size=4000,   # reads per repacked FAST5 file
    nanopolish_output=False,
    dump_adapter_signals=False,
    dump_basecalls=False,
    trim_adapter=False,
    minimum_sequence_length=10,
    nobasecall_stop_trigger=1000,
    resume=False,
    device_batch_size=256,   # rows per stage-1 launch
    wire_precision='exact',  # 'exact' u16 | 'fast' u8 per-read affine
    device='cuda',           # 'cuda' | 'cuda:N' | 'cpu'
    measure_polya=False,
    filter_unsplit_reads=False,
    mesh_shape=None,         # cards in one process (None: every visible)
    num_nodes=None,          # ranks of a multi-process run
    node_rank=None,
    coordinator=None,        # HOST:PORT of rank 0's process-group store
    albacore_onthefly=False,  # basecall each read with albacore (--basecall)
    dashboard=False,
    minimap2_index=None,     # .mmi to align the basecalls to (--align)
)


def ingest_process_count(config):
    """PHASE A's worker processes: ``ingest_processes``, where 'auto' is
    ``parallel`` when that is 2 or more and none otherwise (the batches
    are then loaded in the analyzer's process). None with on-the-fly
    basecalling, as in poreplex-tpu: albacore takes each read's signal
    in the analyzer's process."""
    if config['albacore_onthefly']:
        return 0
    count = config['ingest_processes']
    if count == 'auto':
        count = config['parallel'] if config['parallel'] >= 2 else 0
    return int(count)


def resolve_device(device):
    """The torch device an entry point runs on. CUDA is the default and is
    required unless the caller asked for the CPU; there is no fallback."""
    import torch
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" (--cpu on the command '
            'line) to run the plain PyTorch path on the CPU')
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('unsupported device {}'.format(device))
    return device


def build_config(inputdir, outputdir, preset='', **options):
    """Assemble the runtime config dict: preset, defaults, then options."""
    config = load_preset(preset)
    config.update(copy.deepcopy(DEFAULT_OPTIONS))
    config['inputdir'] = inputdir
    config['outputdir'] = outputdir
    config['tmpdir'] = options.pop('tmpdir', None) or os.path.join(
        outputdir, 'tmp')
    config['cleanup_tmpdir'] = False
    for key, value in options.items():
        if key not in config:
            raise KeyError('Unknown config option: {}'.format(key))
        config[key] = value
    config['device'] = str(resolve_device(config['device']))

    (config['label_names'], config['barcode_names'],
     config['output_layout']) = setup_output_name_mapping(config)
    return config
