"""Data parallelism over reads, with the module names of poreplex-tpu's
``parallel/``:

  mesh.py         the cards (or CPU entries) one process spreads its
                  batches over
  sharding.py     stage 1 over those devices: one engine replica per
                  device, reads round-robined, results in read order
  distributed.py  several processes (ranks): read ownership, and the final
                  count matrices summed with torch.distributed (gloo)
  training.py     data-parallel training, the trainers' counterpart of
                  poreplex-tpu's mesh sharding: one rank a device (NCCL on
                  the cards, gloo on the CPU), the gradients summed by one
                  all-reduce a step
"""

from .training import Replica, join, launch, round_batch  # noqa: F401
