"""Training of the scaler and demultiplexer networks in PyTorch: synthetic
and dump-inventory datasets, the cost-weighted losses, the phred
calibration table, and npz checkpoints that the model classes of both
packages load. The trainers run on the CUDA device unless the caller asks
for the CPU; the recurrences are the plain differentiable ones of
``ops/rnn.py`` under autograd (no Pallas kernel of the JAX package has a
backward pass, and its trainers differentiate through XLA scans)."""
