"""The pre-trained networks and the segmentation HMM.

  scaler        LSTM48-LSTM48-Dense2 signal scaling predictor
  demux         BiLSTM48-LSTM64-Dense5 barcode classifier
  segmentation  6-state Normal/GMM segmentation HMM
"""
