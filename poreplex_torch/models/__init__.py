"""The pre-trained networks and the segmentation HMM.

  scaler        LSTM-LSTM-Dense2 signal scaling predictor (shipped: 48, 48)
  demux         BiLSTM-LSTM-Dense5 barcode classifier (shipped: 48, 64)
  segmentation  Normal/GMM HMMs of the preset (shipped: 6 states)

Each takes the widths its bundle or state list holds: the CUDA kernels
take every LSTM width and HMMs of 1 to 8 states with any number of
mixture components (``kernels/``).
"""
