"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
importing nothing of the program, reading only the raw preset files kept
beside the configurations (``configs/rna-r941/``).

- ``nets``: the published networks' LSTMs and the HMM Viterbi, frozen
  copies of ``poreplex_torch``'s plain ops (float32, TF32 off);
- ``polya``: the poly(A) analyzer as upstream poreplex runs it, one read
  at a time (a frozen copy of ``poreplex_tpu``'s NumPy oracle, with its
  t-statistics and its interval DP vectorised);
- ``pipeline``: the per-read control flow of upstream poreplex from the
  raw signal to the summary row and the FASTQ record.
"""
