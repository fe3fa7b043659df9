"""Data parallelism over reads, with the module names of poreplex-tpu's
``parallel/``:

  mesh.py         the cards (or CPU entries) one process spreads its
                  batches over
  sharding.py     stage 1 over those devices: one engine replica per
                  device, reads round-robined, results in read order
  distributed.py  several processes (ranks): read ownership, and the final
                  count matrices summed with torch.distributed (gloo)
"""
