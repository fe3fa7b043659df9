"""Pipeline: FAST5 ingest -> batched stage 1 on the device -> demux
resolution, adapter trimming and reports -> writers."""
