"""Training of the scaler and demultiplexer networks in PyTorch: synthetic
and dump-inventory datasets, the cost-weighted losses, the phred
calibration table, and npz checkpoints that the model classes of both
packages load. The trainers run on the CUDA device unless the caller asks
for the CPU; the recurrences are the plain differentiable ones of
``ops/rnn.py`` under autograd (no Pallas kernel of the JAX package has a
backward pass, and its trainers differentiate through XLA scans), on one
rank a card with data parallelism (``parallel/training.py``). The two
training workflows, ``workflow.py`` (demux: prepare, filter, train,
evaluate) and ``scaler_workflow.py`` (scaler: extract, purify, split,
train, evaluate), are the port's copies of the JAX package's."""
