"""poreplex-torch: the PyTorch/CUDA port of poreplex-tpu.

Same pipeline, same outputs: signal scaling, HMM segmentation, barcode
demultiplexing, poly(A) tails, the unsplit-read filter, adapter trimming
and every output sink that needs no alignment, behind the same command
line (``python -m poreplex_torch``), with every Pallas kernel of
poreplex-tpu run as a hand-written CUDA kernel for Hopper (``csrc/``). Every entry point runs on
the CUDA device unless the caller asks for ``device='cpu'``, where the
plain PyTorch versions of the kernels run instead.
"""

__all__ = [
    '__version__',
    'OUTPUT_NAME_PASSED', 'OUTPUT_NAME_FAILED',
    'OUTPUT_NAME_ARTIFACT', 'OUTPUT_NAME_BARCODES',
    'OUTPUT_NAME_UNDETERMINED', 'OUTPUT_NAME_BARCODING_OFF',
]

__version__ = '0.1.0'

# output label taxonomy of upstream poreplex, kept so downstream tooling
# reads the port's output tree unchanged
OUTPUT_NAME_PASSED = 'pass'
OUTPUT_NAME_FAILED = 'fail'
OUTPUT_NAME_ARTIFACT = 'artifact'

OUTPUT_NAME_UNDETERMINED = 'undetermined'
OUTPUT_NAME_BARCODES = 'BC{n}'
OUTPUT_NAME_BARCODING_OFF = '-'

# single-writer discipline; avoids HDF5 lock contention on NFS
import os as _os
_os.environ.setdefault('HDF5_USE_FILE_LOCKING', 'FALSE')
del _os
