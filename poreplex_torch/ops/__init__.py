"""Plain PyTorch versions of the stage-1 numeric paths: the reference the
CUDA kernels are held against, and the path CPU tensors take.

  rnn        LSTM recurrences (scaler and demux networks)
  viterbi    batched HMM Viterbi and segment extents
  normalize  masked median and med/MAD normalization
"""
