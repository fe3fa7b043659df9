"""Output sinks: BGZF FASTQ, sequencing summary, final summary."""
